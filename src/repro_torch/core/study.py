"""Parallel Pareto-sweep study layer, copied from ``repro/core/study.py``
with its imports renamed (there it is the worker side of
``benchmarks/sweep.py``, which is not ported).

IPA's headline claim is a *trade-off surface* — accuracy vs cost vs
reconfigurations under varying SLAs and budgets (FA2 and InferLine both
evaluate across dense SLA/budget grids) — and a surface needs a grid of
full policy-trace runs, not spot checks.  Each grid **cell** is one
``(policy, SLA scale, core budget C, trace replicate, objective weights)``
tuple replayed end-to-end through ``adapter.run_cell``; cells are
embarrassingly parallel, so the runner fans them out over a
``ProcessPoolExecutor`` (spawn context) and this module holds everything a
worker process needs to compute a cell *from its spec alone*:

* ``CellSpec`` — a frozen, picklable, filesystem-addressable cell
  identity.  Every input a cell needs is derived deterministically from
  the spec, so a cell's result is independent of which worker runs it,
  in what order, after which other cells — the root of the harness's
  nproc-invariance guarantee (same grid, any worker count, byte-identical
  aggregate modulo wall-clock fields).
* deterministic seed derivation via ``np.random.SeedSequence`` spawn
  keys: replicate ``rep`` draws its trace-shape stream from
  ``SeedSequence(root_seed, spawn_key=(rep, 0))`` and its arrival streams
  from ``spawn_key=(rep, 1, pipeline))`` (the adapter extends the key per
  pipeline).  Distinct replicates can never collide — unlike the
  ``seed + k * i`` arithmetic this replaces — while cells that differ
  only in policy/budget/SLA *share* a replicate's workload by design
  (paired comparison: every policy is judged on the same arrivals).
* per-worker warm state (``worker_init`` + module globals): one
  long-lived ``optimizer.FrontierCache`` and small trace/cluster memos
  reused across all the cells a worker drains.  Exact frontier keying is
  bit-identical to uncached planning (property-tested), so warm caches
  change wall-clock only, never results.
* crash-safe incremental resume: every finished cell is written as one
  shard ``<shards>/<cell_id>.json`` (atomic tmp+rename); a rerun loads
  shards whose embedded spec still matches and recomputes only the rest.
* aggregation: per-(policy, sla, C, beta) means with seed-level 95%
  confidence intervals (Student t over replicates), Pareto fronts per
  (sla, beta) slice over (mean PAS up, mean cost down, reconfigs/hour
  down), and a ``result_hash`` over the volatile-stripped records — the
  equality witness the smoke gate compares across worker counts.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    from scipy.stats import t as _student_t
except ImportError:                      # pragma: no cover - scipy is baked in
    _student_t = None

from repro_torch.core import adapter as AD
from repro_torch.core import optimizer as OPT
from repro_torch.core.cluster import ClusterModel
from repro_torch.core.pipeline import ModelVariant, PipelineModel, StageModel

# §5.3: ~8 s adaptation window per reconfiguration (see bench_cluster's
# switch scenario for how these two constants were sized)
ADAPT_DELAY_S = 8.0
HYSTERESIS_SWITCH_COST = 0.08

# sweep policy name -> (run_cluster_trace policy, switch_cost).  The
# hysteresis variant is a *policy* here (not a knob) so the surface shows
# what the §5.3 switch penalty trades: fewer reconfigs/hour vs PAS.
SWEEP_POLICIES = {
    "ipa": ("ipa", 0.0),
    "ipa_hyst": ("ipa", HYSTERESIS_SWITCH_COST),
    "split_ipa": ("split_ipa", 0.0),
    "split_fa2_low": ("split_fa2_low", 0.0),
    "split_fa2_high": ("split_fa2_high", 0.0),
    "split_rim": ("split_rim", 0.0),
}


# ---------------------------------------------------------------------------
# cell identity
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One grid cell.  Frozen + primitives only: hashable, picklable under
    the spawn context, and serializable into its own shard for resume
    validation.  ``sla_scale`` multiplies every stage SLA of the scenario
    pipelines; ``budget`` is the absolute shared core budget C (resolved
    from a budget fraction by the runner, so cells are self-contained);
    ``rep`` is the trace-replicate index the seed streams derive from."""
    policy: str                  # key of SWEEP_POLICIES
    sla_scale: float
    budget: int
    rep: int
    beta: float                  # objective cost weight (alpha fixed)
    alpha: float = 1.0
    seconds: int = 240
    n_pipelines: int = 3
    root_seed: int = 0
    adaptation_delay: float = ADAPT_DELAY_S
    event_core: str = "struct"

    @property
    def cell_id(self) -> str:
        """Filesystem-safe shard name.  Unique within one grid (grids vary
        the first five axes; the rest are grid-wide constants, and the
        shard loader re-validates the *full* spec anyway)."""
        return (f"{self.policy}__sla{self.sla_scale:g}__C{self.budget}"
                f"__rep{self.rep}__beta{self.beta:g}")

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def spec_from_dict(d: Dict) -> CellSpec:
    return CellSpec(**d)


def build_grid(policies: Sequence[str], sla_scales: Sequence[float],
               budgets: Sequence[int], reps: int, betas: Sequence[float],
               seconds: int, n_pipelines: int,
               root_seed: int = 0,
               adaptation_delay: float = ADAPT_DELAY_S,
               event_core: str = "struct") -> List[CellSpec]:
    """The full cross product, enumerated in a fixed nested order (the
    canonical record order every aggregate and hash uses)."""
    for p in policies:
        if p not in SWEEP_POLICIES:
            raise ValueError(f"unknown sweep policy {p!r}; "
                             f"choose from {sorted(SWEEP_POLICIES)}")
    return [CellSpec(policy=p, sla_scale=float(s), budget=int(c),
                     rep=r, beta=float(b), seconds=int(seconds),
                     n_pipelines=int(n_pipelines), root_seed=int(root_seed),
                     adaptation_delay=float(adaptation_delay),
                     event_core=event_core)
            for p in policies for s in sla_scales for c in budgets
            for b in betas for r in range(reps)]


# ---------------------------------------------------------------------------
# scenario: the bench_cluster anti-correlated-burst cluster, SLA-scalable
# and Generator-seeded (workers rebuild it from the spec alone)
# ---------------------------------------------------------------------------
def _sweep_pipeline(name: str, l1a: float, l1b: float, accs,
                    sla_scale: float) -> PipelineModel:
    """Two-stage pipeline with light/mid/heavy variants per stage (the
    bench_cluster scenario family); ``sla_scale`` multiplies each stage's
    SLA — the sweep's SLA axis."""
    def stage(sname, l1):
        variants = tuple(
            ModelVariant(f"{sname}_{tag}", acc, alloc,
                         (l1 * scale * 0.002, l1 * scale * 0.7,
                          l1 * scale * 0.3))
            for tag, acc, alloc, scale in zip(
                ("light", "mid", "heavy"), accs, (1, 2, 4), (1.0, 1.8, 3.2)))
        return StageModel(sname, variants, sla=5 * l1 * 1.8 * sla_scale,
                          batch_choices=(1, 2, 4, 8, 16))
    return PipelineModel(name, (stage(f"{name}_a", l1a),
                                stage(f"{name}_b", l1b)))


_PIPELINE_PROTOS = (
    ("vision", 0.040, 0.030, (55.0, 71.0, 82.0)),
    ("audio", 0.050, 0.020, (62.0, 70.0, 76.0)),
    ("nlp", 0.030, 0.030, (66.0, 74.0, 80.0)),
    ("video", 0.045, 0.025, (52.0, 68.0, 84.0)),
)

# rotating-burst trace shape (one pipeline near peak at a time — the
# regime where moving cores across pipelines pays)
TRACE_BASE_RPS = 4.0
TRACE_BURST_AMP = 22.0
TRACE_CYCLE_S = 90.0
TRACE_DECAY_S = 14.0


def sweep_cluster(n_pipelines: int, sla_scale: float = 1.0,
                  cores: float = float("inf")) -> ClusterModel:
    if not 1 <= n_pipelines <= len(_PIPELINE_PROTOS):
        raise ValueError(f"n_pipelines must be 1-{len(_PIPELINE_PROTOS)}")
    pipes = tuple(_sweep_pipeline(*proto, sla_scale=sla_scale)
                  for proto in _PIPELINE_PROTOS[:n_pipelines])
    return ClusterModel("sweep_cluster", pipes, float(cores))


def sweep_traces(seconds: int, n: int,
                 rng: np.random.Generator) -> List[np.ndarray]:
    """Anti-correlated rotating bursts, phase-shifted per pipeline, noise
    drawn from ``rng`` (a Generator, so the caller controls derivation)."""
    t = np.arange(seconds, dtype=np.float64)
    traces = []
    for i in range(n):
        phase = (t - i * TRACE_CYCLE_S / n) % TRACE_CYCLE_S
        burst = TRACE_BURST_AMP * np.exp(-phase / TRACE_DECAY_S)
        noise = rng.normal(0.0, 0.4, seconds)
        traces.append(np.clip(TRACE_BASE_RPS + burst + noise, 0.5, None))
    return traces


def resolve_budgets(n_pipelines: int, fracs: Sequence[float],
                    beta: float = 0.02) -> List[int]:
    """Budget fractions -> absolute core budgets C, deterministically.

    The reference is the unconstrained joint cost at the worst rotating
    window (one pipeline at the analytic burst peak, the rest at base
    load) under the grid's planning objective — the same sizing rule as
    ``bench_cluster.pick_budget`` but on analytic demand points, so it
    needs no traces and every invocation agrees on the result.  Budgets
    are resolved once per grid (not per beta): the C axis must stay
    comparable across objective weights."""
    unbounded = sweep_cluster(n_pipelines)
    obj = OPT.Objective(alpha=1.0, beta=beta, delta=1e-6)
    peak = TRACE_BASE_RPS + TRACE_BURST_AMP
    worst = 0.0
    for i in range(n_pipelines):
        lams = [peak if j == i else TRACE_BASE_RPS
                for j in range(n_pipelines)]
        worst = max(worst, OPT.solve_cluster(unbounded, lams, obj).cost)
    return [max(int(round(f * worst)), n_pipelines * 2) for f in fracs]


# ---------------------------------------------------------------------------
# deterministic seed derivation (collision-free by SeedSequence spawn keys)
# ---------------------------------------------------------------------------
def trace_seedseq(spec: CellSpec) -> np.random.SeedSequence:
    """Replicate ``rep``'s trace-shape noise stream."""
    return np.random.SeedSequence(entropy=spec.root_seed,
                                  spawn_key=(spec.rep, 0))


def arrival_seedseq(spec: CellSpec) -> np.random.SeedSequence:
    """Replicate ``rep``'s arrival-sampling root; ``run_cluster_trace``
    extends the spawn key per pipeline (``(rep, 1, i)``)."""
    return np.random.SeedSequence(entropy=spec.root_seed,
                                  spawn_key=(spec.rep, 1))


# ---------------------------------------------------------------------------
# worker side: warm state + the single-cell entry point
# ---------------------------------------------------------------------------
_WORKER: Dict = {}


def worker_init() -> None:
    """Per-process warm state, built once per worker (the pool passes this
    as the executor ``initializer``; the serial path calls it per run).
    The planner cache is exact-keyed at every layer (frontiers, whole
    solves, DP prefixes), so sharing it across every cell a worker drains
    is a pure wall-clock win — bit-identical results."""
    _WORKER["frontier_cache"] = OPT.PlannerCache(max_entries=8192)
    _WORKER["traces"] = {}
    _WORKER["clusters"] = {}


def _traces_for(spec: CellSpec) -> List[np.ndarray]:
    key = (spec.seconds, spec.n_pipelines, spec.root_seed, spec.rep)
    memo = _WORKER["traces"]
    if key not in memo:
        if len(memo) >= 32:              # bounded like the trace cache
            memo.pop(next(iter(memo)))
        rng = np.random.default_rng(trace_seedseq(spec))
        memo[key] = sweep_traces(spec.seconds, spec.n_pipelines, rng)
    return memo[key]


def _cluster_for(spec: CellSpec) -> ClusterModel:
    key = (spec.n_pipelines, spec.sla_scale, spec.budget)
    memo = _WORKER["clusters"]
    if key not in memo:
        memo[key] = sweep_cluster(spec.n_pipelines, spec.sla_scale,
                                  float(spec.budget))
    return memo[key]


def run_cell_spec(spec: CellSpec) -> Dict:
    """Compute one cell from its spec alone (worker entry point)."""
    if not _WORKER:
        worker_init()
    policy, switch_cost = SWEEP_POLICIES[spec.policy]
    rec = AD.run_cell(
        _cluster_for(spec), _traces_for(spec), policy=policy,
        obj=OPT.Objective(alpha=spec.alpha, beta=spec.beta, delta=1e-6),
        seed=arrival_seedseq(spec), switch_cost=switch_cost,
        adaptation_delay=spec.adaptation_delay,
        frontier_cache=_WORKER["frontier_cache"],
        event_core=spec.event_core)
    rec["cell"] = spec.cell_id
    rec["spec"] = spec.to_dict()
    return rec


def run_chunk(specs: Sequence[CellSpec]) -> List[Dict]:
    """A chunk of cells in one pool task (amortizes task dispatch; the
    runner keeps chunks small so free workers can steal queued ones)."""
    return [run_cell_spec(s) for s in specs]


# ---------------------------------------------------------------------------
# shards: crash-safe incremental resume
# ---------------------------------------------------------------------------
def shard_path(shard_dir: str, spec: CellSpec) -> str:
    return os.path.join(shard_dir, spec.cell_id + ".json")


def write_shard(shard_dir: str, rec: Dict) -> None:
    """Atomic per-cell result shard (tmp + rename in the same directory,
    so a crash mid-write can never leave a half-shard a resume would
    trust)."""
    os.makedirs(shard_dir, exist_ok=True)
    path = os.path.join(shard_dir, rec["cell"] + ".json")
    fd, tmp = tempfile.mkstemp(dir=shard_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_shard(shard_dir: str, spec: CellSpec) -> Optional[Dict]:
    """A completed cell's record, or None if absent/corrupt/stale.  The
    embedded spec must match exactly — a shard from an edited grid (or a
    truncated write that somehow survived) is recomputed, not trusted."""
    path = shard_path(shard_dir, spec)
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    if rec.get("spec") != spec.to_dict():
        return None
    return rec


# ---------------------------------------------------------------------------
# aggregation: CIs, Pareto fronts, determinism hash
# ---------------------------------------------------------------------------
# record fields that legitimately vary run-to-run (wall clock) or with
# warm-cache history (hit/miss counts): stripped before hashing, and the
# only fields the nproc-invariance guarantee excludes
VOLATILE_KEYS = frozenset({"wall_s", "solver_wall_s", "sim_wall_s",
                           "frontier_cache"})


def strip_volatile(obj):
    """Recursively drop wall-clock / cache-history fields."""
    if isinstance(obj, dict):
        return {k: strip_volatile(v) for k, v in obj.items()
                if k not in VOLATILE_KEYS}
    if isinstance(obj, (list, tuple)):
        return [strip_volatile(v) for v in obj]
    return obj


def result_hash(records: Sequence[Dict]) -> str:
    """sha256 over the canonical JSON of the volatile-stripped records,
    sorted by cell id — the byte-identity witness compared across worker
    counts."""
    canon = sorted((strip_volatile(r) for r in records),
                   key=lambda r: r["cell"])
    blob = json.dumps(canon, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def _ci(vals: Sequence[float]) -> Dict:
    """Mean with a seed-level 95% CI halfwidth (Student t over the
    replicate axis; ``ci95`` is None with a single replicate)."""
    v = np.asarray(vals, np.float64)
    n = len(v)
    out = {"mean": round(float(v.mean()), 6), "n": n}
    if n > 1:
        sd = float(v.std(ddof=1))
        mult = float(_student_t.ppf(0.975, n - 1)) if _student_t is not None \
            else 1.96                    # pragma: no cover - scipy absent
        out["std"] = round(sd, 6)
        out["ci95"] = round(mult * sd / np.sqrt(n), 6)
    else:
        out["std"] = None
        out["ci95"] = None
    return out


_SURFACE_METRICS = ("mean_pas", "mean_cost", "mean_objective",
                    "reconfigs_per_hour", "sla_violation_rate", "dropped",
                    "peak_serving_cores")


def aggregate(records: Sequence[Dict]) -> Dict:
    """Collapse cell records into the study output.

    ``groups``: one entry per (policy, sla_scale, budget, beta) with
    replicate-level mean/std/CI95 for each surface metric.  ``pareto``:
    per (sla_scale, beta) slice, every (policy, budget) operating point
    with its Pareto flag over (mean PAS maximized, mean cost minimized,
    reconfigs/hour minimized) — the paper's trade-off surface, read
    straight from the JSON."""
    groups: Dict[Tuple, List[Dict]] = {}
    for r in records:
        s = r["spec"]
        key = (s["policy"], s["sla_scale"], s["budget"], s["beta"])
        groups.setdefault(key, []).append(r)

    group_rows = []
    for (policy, sla, budget, beta) in sorted(groups):
        cells = sorted(groups[(policy, sla, budget, beta)],
                       key=lambda r: r["spec"]["rep"])
        row = {"policy": policy, "sla_scale": sla, "budget": budget,
               "beta": beta, "reps": [c["spec"]["rep"] for c in cells]}
        for m in _SURFACE_METRICS:
            row[m] = _ci([c[m] for c in cells])
        group_rows.append(row)

    fronts = []
    slices: Dict[Tuple, List[Dict]] = {}
    for row in group_rows:
        slices.setdefault((row["sla_scale"], row["beta"]), []).append(row)
    for (sla, beta) in sorted(slices):
        pts = [{"policy": row["policy"], "budget": row["budget"],
                "mean_pas": row["mean_pas"]["mean"],
                "mean_cost": row["mean_cost"]["mean"],
                "reconfigs_per_hour": row["reconfigs_per_hour"]["mean"]}
               for row in slices[(sla, beta)]]
        for p in pts:
            p["pareto"] = not any(
                q is not p
                and q["mean_pas"] >= p["mean_pas"]
                and q["mean_cost"] <= p["mean_cost"]
                and q["reconfigs_per_hour"] <= p["reconfigs_per_hour"]
                and (q["mean_pas"] > p["mean_pas"]
                     or q["mean_cost"] < p["mean_cost"]
                     or q["reconfigs_per_hour"] < p["reconfigs_per_hour"])
                for q in pts)
        fronts.append({"sla_scale": sla, "beta": beta, "points": pts})

    return {"groups": group_rows, "pareto": fronts}


def timing_rollup(records: Sequence[Dict], top_n: int = 5) -> Dict:
    """The volatile side, rolled up for diagnosability: total solver vs
    simulator wall across cells, aggregate frontier-cache hit rate, and
    the slowest cells (stragglers) with their own phase breakdown."""
    total_wall = sum(r["wall_s"] for r in records)
    solver = sum(r["solver_wall_s"] for r in records)
    sim = sum(r["sim_wall_s"] for r in records)
    hits = sum(r["frontier_cache"]["hits"] for r in records
               if r.get("frontier_cache"))
    misses = sum(r["frontier_cache"]["misses"] for r in records
                 if r.get("frontier_cache"))
    stragglers = sorted(records, key=lambda r: -r["wall_s"])[:top_n]
    return {
        "cells": len(records),
        "cell_wall_s_total": round(total_wall, 3),
        "solver_wall_s_total": round(solver, 3),
        "sim_wall_s_total": round(sim, 3),
        "frontier_cache": {
            "hits": hits, "misses": misses,
            "hit_rate": round(hits / (hits + misses), 4)
            if hits + misses else 0.0},
        "stragglers": [
            {"cell": r["cell"], "wall_s": r["wall_s"],
             "solver_wall_s": r["solver_wall_s"],
             "sim_wall_s": r["sim_wall_s"]} for r in stragglers],
    }
