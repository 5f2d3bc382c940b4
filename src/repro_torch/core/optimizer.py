"""IPA's optimizer: the Integer Program of Eq. 10.

Decision per stage: (variant m, batch b, replicas n).  Key structural fact
used by every solver here: the objective strictly decreases in n (-beta n R)
and n appears only in the throughput constraint (10c), so the optimal
replica count for a chosen (m, b) is n*(m, b) = ceil(lambda / h_m(b)).
Substituting n* collapses the IP to "pick one (m, b) option per stage under
a total-latency budget" — which we solve four ways:

  * ``solve_vec``   -- exact enumeration of the option cross-product as one
    numpy broadcast over the per-stage option tables (feasibility mask, SLA
    cutoff and objective scoring all as float64 array ops; first-index
    argmax tie-break).  Exact for the true multiplicative PAS and
    bit-identical to ``solve_brute`` by construction (same accumulation
    order, same tie-break) — this is the adaptation loop's hot path.
  * ``solve_enum``  -- the same enumeration vectorized with torch on a
    device (the card unless ``device`` says otherwise; radix-decoded combo
    indices in chunks, feasibility-masked first-index argmax), kept as a
    cross-check reference.  NOTE: it evaluates in float32, as the
    reference's jnp does, so an *exact* objective tie can resolve to a
    different (equal-valued) config than the float64 solvers.
  * ``solve_milp``  -- scipy HiGHS MILP (the Gurobi stand-in, §4.4) over
    binary x_{s,j}.  Exact for the *linear* accuracy metrics: PAS'
    (Appendix C) or log-PAS (a monotone surrogate of Eq. 8; exact tradeoff
    weighting differs from alpha*PAS — documented).  Scales to the paper's
    Fig.-13 regime (10 stages x 10 models in < 2 s).
  * ``solve_brute`` -- plain-python oracle for the property tests.

Cluster level (paper §6 discussion): ``pareto_frontier`` reduces one
pipeline at one rate to its cost -> objective Pareto frontier (any
off-frontier config is dominated and can never appear in an optimal joint
allocation); ``solve_cluster`` then arbitrates one frontier point per
pipeline under the shared core budget with an exact multiple-choice
knapsack DP (costs are integral: replicas x base allocation).  The DP is
switch-cost-aware (paper §5.3): given the incumbent ``ClusterConfig`` it
charges ``switch_cost`` per changed pipeline (the held config enters as a
zero-penalty stay candidate via ``evaluate_config``, which is hysteresis),
optionally caps changes per interval with an exact second DP dimension
(``switch_budget``), weights pipelines by SLA importance
(``sla_weights``), and — with ``overlap=True`` — plans each pipeline
against the transition charge ``max(old, new)`` so that a §5.3 adaptation
window (old fleet serving while the new one provisions) can never push
instantaneous serving capacity past the shared budget.  ``solve_capped``
is the per-pipeline sub-problem the proportional static-split baselines
run inside their budget share, and ``solve_cluster_brute`` is the
cross-product oracle for the tests.  The knob semantics live in one
place: the ``solve_cluster`` docstring.

``FrontierCache`` memoizes ``pareto_frontier`` across adaptation
intervals: a policy trace revisits the same (pipeline, rate) demand
points constantly (reactive estimators hold a value through many
boundaries), so with a cache threaded through ``solve_cluster`` /
``solve_capped`` most per-interval frontier builds become dict hits.
Exact keying (the default) is bit-identical to uncached planning.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import accuracy as ACC
from repro_torch.core.pipeline import (PipelineConfig, PipelineModel, StageConfig,
                                 StageModel)
from repro_torch.core.queueing import expected_wait, queue_delay

DEFAULT_MAX_REPLICAS = 64


@dataclasses.dataclass(frozen=True)
class Objective:
    alpha: float = 1.0          # accuracy weight
    beta: float = 0.1           # resource weight
    delta: float = 1e-6         # batch penalty (paper: 1e-6)
    metric: str = "pas"         # pas | pas_prime | log_pas


@dataclasses.dataclass
class StageOptions:
    """Per-stage flattened (variant, device class, batch) options with n*
    substituted.  Single-class stages (no ``device_profiles`` anywhere)
    flatten to exactly the legacy (variant, batch) grid in the legacy
    order, with every ``devices`` entry ``"cpu"``."""
    names: List[str]
    batches: np.ndarray          # (J,)
    lat: np.ndarray              # (J,) model latency + queue delay
    cost: np.ndarray             # (J,) n* x R_m (in the class's own units)
    acc: np.ndarray              # (J,) raw accuracy (0-100 scale)
    acc_norm: np.ndarray         # (J,) rank-normalized (PAS')
    replicas: np.ndarray         # (J,) n*
    feasible: np.ndarray         # (J,) bool
    devices: List[str] = dataclasses.field(default_factory=list)


class _StageTable:
    """Rate-independent expansion of one stage's (variant, device, batch)
    grid: every column ``stage_options`` computes that does not depend on
    the arrival rate, flattened in the exact enumeration order.  Cached by
    ``PlannerCache`` so a frontier build at a *new* rate only runs the
    cheap n*/feasibility arithmetic over these columns instead of
    re-walking the model objects (the profiled hot spot of a cold solve).
    The per-option floats are the very values the uncached loop computes
    (same calls, made once), so the rebuilt ``StageOptions`` is
    bit-identical by construction.  Shared arrays (``batches``, ``acc``,
    ``accn``) and lists are treated as immutable by all callers — the same
    discipline as ``FrontierCache``'s shared frontier lists."""

    __slots__ = ("names", "devices", "batches_l", "h", "svc", "alloc",
                 "acc_l", "accn_l", "batches", "acc", "accn")

    def __init__(self, stage: StageModel):
        names, devices, batches, h, svc, alloc, acc, accn = \
            ([] for _ in range(8))
        pairs = [(v, d) for v in stage.variants for d in v.device_classes]
        norm = dict(zip(((v.name, d) for v, d in pairs),
                        ACC.rank_normalized([v.acc(d) for v, d in pairs])))
        for v in stage.variants:
            for d in v.device_classes:
                for b in stage.batch_choices:
                    names.append(v.name)
                    devices.append(d)
                    batches.append(b)
                    h.append(float(v.throughput(b, d)))
                    svc.append(float(v.latency(b, d)))
                    alloc.append(v.alloc(d))
                    acc.append(v.acc(d))
                    accn.append(norm[(v.name, d)])
        self.names = names
        self.devices = devices
        self.batches_l = batches
        self.h = h
        self.svc = svc
        self.alloc = alloc
        self.acc_l = acc
        self.accn_l = accn
        self.batches = np.array(batches)
        self.acc = np.array(acc)
        self.accn = np.array(accn)


def _options_from_table(tab: _StageTable, arrival: float, max_replicas: int,
                        latency_model: str) -> StageOptions:
    """The rate-dependent half of ``stage_options`` over cached static
    columns — the identical scalar arithmetic on the identical floats, so
    the result is bit-for-bit the uncached expansion."""
    lat, cost, reps, feas = [], [], [], []
    qd = {b: float(queue_delay(b, arrival)) for b in set(tab.batches_l)}
    expected = latency_model == "expected"
    for i, b in enumerate(tab.batches_l):
        h = tab.h[i]
        n = (max(1, math.ceil(max(arrival, 1e-9) / h)) if h > 0
             else max_replicas + 1)
        ok = n <= max_replicas and n * h >= arrival - 1e-9
        svc = tab.svc[i]
        if expected:
            lat.append(svc + float(expected_wait(b, arrival, n, svc)))
        else:
            lat.append(svc + qd[b])
        cost.append(n * tab.alloc[i])
        reps.append(n)
        feas.append(ok)
    return StageOptions(tab.names, tab.batches, np.array(lat),
                        np.array(cost, np.float64), tab.acc, tab.accn,
                        np.array(reps), np.array(feas), tab.devices)


def stage_options(stage: StageModel, arrival: float,
                  max_replicas: int = DEFAULT_MAX_REPLICAS,
                  latency_model: str = "worst_case",
                  tables: Optional[dict] = None) -> StageOptions:
    """Flatten a stage's (variant, device class, batch) grid with n*
    substituted.  The device loop nests between variant and batch, so a
    single-class stage enumerates bit-identically to the pre-device grid.

    ``latency_model``: ``"worst_case"`` keeps Eq. 7's bound (the default,
    bit-identical to the original planner); ``"expected"`` opts into the
    M/M/c-style mean delay (``core.queueing.expected_wait``) at the
    substituted replica count n*.

    ``tables``: an optional ``{stage: _StageTable}`` memo (threaded down
    from ``PlannerCache``) of the rate-independent columns; with it only
    the n*/feasibility/queue-delay arithmetic runs per rate.  Both paths
    produce bit-identical ``StageOptions`` (property-tested).
    """
    if latency_model not in ("worst_case", "expected"):
        raise ValueError(latency_model)
    if tables is not None:
        tab = tables.get(stage)
        if tab is None:
            tab = tables[stage] = _StageTable(stage)
        return _options_from_table(tab, arrival, max_replicas, latency_model)
    names, batches, lat, cost, acc, accn, reps, feas = ([] for _ in range(8))
    devices: List[str] = []
    pairs = [(v, d) for v in stage.variants for d in v.device_classes]
    norm = dict(zip(((v.name, d) for v, d in pairs),
                    ACC.rank_normalized([v.acc(d) for v, d in pairs])))
    for v in stage.variants:
        for d in v.device_classes:
            for b in stage.batch_choices:
                h = float(v.throughput(b, d))
                n = (max(1, math.ceil(max(arrival, 1e-9) / h)) if h > 0
                     else max_replicas + 1)
                ok = n <= max_replicas and n * h >= arrival - 1e-9
                names.append(v.name)
                devices.append(d)
                batches.append(b)
                svc = float(v.latency(b, d))
                if latency_model == "expected":
                    lat.append(svc + float(expected_wait(b, arrival, n, svc)))
                else:
                    lat.append(svc + float(queue_delay(b, arrival)))
                cost.append(n * v.alloc(d))
                acc.append(v.acc(d))
                accn.append(norm[(v.name, d)])
                reps.append(n)
                feas.append(ok)
    return StageOptions(names, np.array(batches), np.array(lat),
                        np.array(cost, np.float64), np.array(acc),
                        np.array(accn), np.array(reps), np.array(feas),
                        devices)


def _apply_restrictions(pipe: PipelineModel, opts: List[StageOptions],
                        restrict_variants: Optional[Sequence[str]],
                        fixed_replicas: Optional[int], arrival: float):
    if restrict_variants is not None:
        for o, vname in zip(opts, restrict_variants):
            keep = np.array([n == vname for n in o.names])
            o.feasible = o.feasible & keep
    if fixed_replicas is not None:
        for o, stage in zip(opts, pipe.stages):
            o.replicas = np.full_like(o.replicas, fixed_replicas)
            o.cost = np.array([fixed_replicas * stage.variant(n).alloc(d)
                               for n, d in zip(o.names, o.devices)],
                              np.float64)
            # throughput must still clear arrival at the pinned replication
            thr = np.array(
                [fixed_replicas * float(stage.variant(n).throughput(b, d))
                 for n, b, d in zip(o.names, o.batches, o.devices)])
            o.feasible = o.feasible & (thr >= arrival - 1e-9)
    return opts


def _acc_term(o: StageOptions, metric: str) -> np.ndarray:
    if metric == "pas":
        # log-space; combined multiplicatively then exponentiated exactly
        return np.log(np.maximum(o.acc, 1e-9) / 100.0)
    if metric == "pas_prime":
        return o.acc_norm
    if metric == "log_pas":
        return np.log(np.maximum(o.acc, 1e-9) / 100.0)
    raise ValueError(metric)


def _combine_acc(total_log_or_sum: np.ndarray, metric: str) -> np.ndarray:
    if metric == "pas":
        return 100.0 * np.exp(total_log_or_sum)
    return total_log_or_sum


@dataclasses.dataclass
class Solution:
    config: Optional[PipelineConfig]
    objective: float
    pas: float
    cost: float
    latency: float
    solve_time: float
    feasible: bool
    solver: str


def _mk_solution(pipe, opts, picks, obj: Objective, arrival, t0, solver):
    stages = []
    accs = []
    lats = []
    lat = cost = bat = 0.0
    for o, j, st in zip(opts, picks, pipe.stages):
        stages.append(StageConfig(o.names[j], int(o.batches[j]),
                                  int(o.replicas[j]), o.devices[j]))
        accs.append(o.acc[j])
        lats.append(o.lat[j])
        lat += o.lat[j]
        cost += o.cost[j]
        bat += o.batches[j]
    if not pipe.is_chain:
        # critical-path latency: max over source->sink paths of the
        # per-stage sums (parallel branches overlap, they don't serialize)
        lat = -np.inf
        for path in pipe.paths():
            t = 0.0
            for i in path:
                t += lats[i]
            if t > lat:
                lat = t
    acc_val = (ACC.pas(accs) if obj.metric == "pas"
               else sum(_acc_term(o, obj.metric)[j] for o, j in zip(opts, picks)))
    objective = obj.alpha * acc_val - obj.beta * cost - obj.delta * bat
    return Solution(PipelineConfig(tuple(stages)), float(objective),
                    ACC.pas(accs), float(cost), float(lat),
                    time.perf_counter() - t0, True, solver)


def _infeasible(t0, solver):
    return Solution(None, -np.inf, 0.0, 0.0, np.inf,
                    time.perf_counter() - t0, False, solver)


# ---------------------------------------------------------------------------
# exact enumeration (numpy broadcast — the hot path)
# ---------------------------------------------------------------------------
def _broadcast_eval(opts: List[StageOptions], obj: Objective, sla: float,
                    stage0_fastest: bool = True,
                    paths: Optional[Sequence[Tuple[int, ...]]] = None):
    """Evaluate the full option cross-product as one numpy broadcast.

    With ``stage0_fastest`` (the frontier/combo convention), combo ``k``'s
    stage-``s`` pick is ``(k // prod(sizes[:s])) % sizes[s]`` — stage ``s``
    maps to axis ``S-1-s`` of the broadcast lattice so the C-order ravel
    enumerates combos in exactly that order.  With it off, the flat order
    is ``itertools.product``'s (last stage fastest — ``solve_brute``'s
    scan order, which is what makes ``solve_vec``'s first-index argmax
    tie-break match the oracle's strict-improvement scan exactly).
    Either way, accumulation runs in stage order with the same float64
    operations as the retired per-stage fancy-indexing loop (and as
    ``solve_brute``'s python sums), so every returned array is
    bit-identical to both — the frontier/oracle property tests pin this.

    ``paths`` (DAG pipelines): the source→sink stage-index paths from
    ``PipelineModel.paths()``.  The SLA latency then becomes the
    critical-path reduction — per-path sums (stage adds in path order)
    maxed elementwise across paths in list order — instead of one total
    over all stages.  ``None`` (chains) keeps the legacy single-sum float
    path untouched; both reductions are pinned bit-identical to the brute
    path-enumeration oracle.

    Returns flat length-``prod(sizes)`` arrays:
    ``(ok, score, cost, pas, lat)`` — ``lat`` being the critical-path
    latency when ``paths`` is given.
    """
    S = len(opts)

    def view(col: np.ndarray, s: int) -> np.ndarray:
        shape = [1] * S
        shape[(S - 1 - s) if stage0_fastest else s] = len(col)
        return np.asarray(col).reshape(shape)

    lat_views = [view(o.lat, s) for s, o in enumerate(opts)]
    if paths is None:
        lat_tot = lat_views[0]
        for s in range(1, S):
            lat_tot = lat_tot + lat_views[s]
    else:
        lat_tot = None
        for path in paths:
            pl = lat_views[path[0]]
            for i in path[1:]:
                pl = pl + lat_views[i]
            lat_tot = pl if lat_tot is None else np.maximum(lat_tot, pl)
    cost_tot = view(opts[0].cost, 0)
    bat_tot = view(opts[0].batches.astype(np.float64), 0)
    pas_log_tot = view(_acc_term(opts[0], "pas"), 0)
    acc_tot = (pas_log_tot if obj.metric == "pas"
               else view(_acc_term(opts[0], obj.metric), 0))
    ok = view(opts[0].feasible, 0)
    for s, o in enumerate(opts[1:], start=1):
        cost_tot = cost_tot + view(o.cost, s)
        bat_tot = bat_tot + view(o.batches.astype(np.float64), s)
        pas_term = view(_acc_term(o, "pas"), s)
        pas_log_tot = pas_log_tot + pas_term
        acc_tot = (pas_log_tot if obj.metric == "pas"
                   else acc_tot + view(_acc_term(o, obj.metric), s))
        ok = ok & view(o.feasible, s)
    lat_tot = np.broadcast_to(lat_tot, ok.shape).reshape(-1)
    cost_tot = np.broadcast_to(cost_tot, ok.shape).reshape(-1)
    bat_tot = np.broadcast_to(bat_tot, ok.shape).reshape(-1)
    pas_log_tot = np.broadcast_to(pas_log_tot, ok.shape).reshape(-1)
    acc_tot = (pas_log_tot if obj.metric == "pas"
               else np.broadcast_to(acc_tot, ok.shape).reshape(-1))
    ok = ok.reshape(-1) & (lat_tot <= sla)
    acc_val = _combine_acc(acc_tot, obj.metric)
    score = obj.alpha * acc_val - obj.beta * cost_tot - obj.delta * bat_tot
    pas_val = 100.0 * np.exp(pas_log_tot)
    return ok, score, cost_tot, pas_val, lat_tot


def _unravel_picks(k: int, sizes: Sequence[int]) -> List[int]:
    """Per-stage option indices of flat combo ``k`` in
    ``itertools.product`` order (last stage fastest-varying)."""
    picks = []
    for j in reversed(sizes):
        picks.append(int(k % j))
        k //= j
    return list(reversed(picks))


def solve_vec(pipe: PipelineModel, arrival: float,
              obj: Objective = Objective(),
              max_replicas: int = DEFAULT_MAX_REPLICAS,
              restrict_variants=None, fixed_replicas=None,
              latency_model: str = "worst_case",
              max_combos: int = 1 << 23) -> Solution:
    """Exact enumeration of Eq. 10 as float64 numpy broadcast ops.

    Bit-identical to ``solve_brute`` by construction: same per-stage
    accumulation order, same feasibility/SLA boundary, and ``np.argmax``'s
    first-occurrence tie-break over the ``itertools.product``-ordered
    lattice matches the oracle's strict-improvement scan.  This is the
    per-interval decision loop's solver — no per-call JIT tracing, just a
    handful of array ops over the option lattice.
    """
    t0 = time.perf_counter()
    opts = [stage_options(s, arrival, max_replicas, latency_model)
            for s in pipe.stages]
    opts = _apply_restrictions(pipe, opts, restrict_variants, fixed_replicas,
                               arrival)
    sizes = [len(o.names) for o in opts]
    if math.prod(sizes) > max_combos:
        raise ValueError(f"pipeline {pipe.name}: {math.prod(sizes)} combos "
                         f"exceed the vectorized cap {max_combos}; use "
                         f"solve_milp")
    ok, score, _, _, _ = _broadcast_eval(
        opts, obj, pipe.sla, stage0_fastest=False,
        paths=None if pipe.is_chain else pipe.paths())
    score = np.where(ok, score, -np.inf)
    k = int(np.argmax(score))
    if not np.isfinite(score[k]):
        return _infeasible(t0, "vec")
    return _mk_solution(pipe, opts, _unravel_picks(k, sizes), obj, arrival,
                        t0, "vec")


# ---------------------------------------------------------------------------
# exact enumeration (torch -- float32 cross-check reference)
# ---------------------------------------------------------------------------
def solve_enum(pipe: PipelineModel, arrival: float, obj: Objective = Objective(),
               max_replicas: int = DEFAULT_MAX_REPLICAS,
               restrict_variants=None, fixed_replicas=None,
               chunk: int = 1 << 20,
               latency_model: str = "worst_case", device=None) -> Solution:
    import torch

    from repro_torch import device as D

    dev = D.resolve(device)
    t0 = time.perf_counter()
    opts = [stage_options(s, arrival, max_replicas, latency_model)
            for s in pipe.stages]
    opts = _apply_restrictions(pipe, opts, restrict_variants, fixed_replicas,
                               arrival)
    S = len(opts)
    J = max(len(o.names) for o in opts)

    def pad(x, fill):
        return np.stack([np.pad(np.asarray(x(o), np.float64),
                                (0, J - len(o.names)),
                                constant_values=fill) for o in opts])

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    acc_t = f32(pad(lambda o: _acc_term(o, obj.metric), 0.0))
    lat = f32(pad(lambda o: o.lat, 1e18))
    cost = f32(pad(lambda o: o.cost, 1e18))
    bat = f32(pad(lambda o: o.batches.astype(np.float64), 1e18))
    valid = torch.as_tensor(pad(lambda o: o.feasible.astype(np.float64), 0.0) > 0.5,
                            device=dev)
    sla = f32(pipe.sla)
    K = J ** S
    # int64 combo indices: the reference's int32 radix caps J ** S at 2^31
    radix = torch.tensor([J ** s for s in range(S)], dtype=torch.int64, device=dev)
    stage = torch.arange(S, device=dev)
    path_idx = (None if pipe.is_chain
                else [torch.tensor(p, dtype=torch.int64, device=dev)
                      for p in pipe.paths()])

    def eval_combos(ks):
        js = (ks[:, None] // radix) % J                     # (n, S)
        lat_k = lat[stage, js]
        if path_idx is None:
            lat_ok = lat_k.sum(-1) <= sla
        else:                            # critical path: every path in SLA
            lat_ok = torch.stack([lat_k[:, p].sum(-1) for p in path_idx],
                                 dim=-1).le(sla).all(-1)
        ok = valid[stage, js].all(-1) & lat_ok
        a = acc_t[stage, js].sum(-1)
        if obj.metric == "pas":
            a = 100.0 * torch.exp(a)
        score = obj.alpha * a - obj.beta * cost[stage, js].sum(-1) \
            - obj.delta * bat[stage, js].sum(-1)
        return torch.where(ok, score, -torch.inf)

    best_k, best_v = -1, -np.inf
    for start in range(0, K, chunk):
        ks = torch.arange(start, min(start + chunk, K), dtype=torch.int64, device=dev)
        vals = eval_combos(ks)
        i = int(torch.argmax(vals))          # the first maximum, as argmax
        if float(vals[i]) > best_v:
            best_v, best_k = float(vals[i]), start + i
    if not np.isfinite(best_v):
        return _infeasible(t0, "enum")
    picks = [(best_k // (J ** s)) % J for s in range(S)]
    return _mk_solution(pipe, opts, picks, obj, arrival, t0, "enum")


# ---------------------------------------------------------------------------
# plain-python oracle
# ---------------------------------------------------------------------------
def solve_brute(pipe: PipelineModel, arrival: float,
                obj: Objective = Objective(),
                max_replicas: int = DEFAULT_MAX_REPLICAS,
                restrict_variants=None, fixed_replicas=None,
                latency_model: str = "worst_case") -> Solution:
    t0 = time.perf_counter()
    opts = [stage_options(s, arrival, max_replicas, latency_model)
            for s in pipe.stages]
    opts = _apply_restrictions(pipe, opts, restrict_variants, fixed_replicas,
                               arrival)
    best, best_v = None, -np.inf
    paths = None if pipe.is_chain else pipe.paths()
    ranges = [range(len(o.names)) for o in opts]
    for picks in itertools.product(*ranges):
        if not all(o.feasible[j] for o, j in zip(opts, picks)):
            continue
        if paths is None:
            lat = sum(o.lat[j] for o, j in zip(opts, picks))
        else:
            # brute path enumeration: per-path sums in path order, maxed
            # in path-list order — the oracle _broadcast_eval must match
            lat = -np.inf
            for path in paths:
                t = 0.0
                for i in path:
                    t += opts[i].lat[picks[i]]
                if t > lat:
                    lat = t
        if lat > pipe.sla:
            continue
        a = sum(_acc_term(o, obj.metric)[j] for o, j in zip(opts, picks))
        if obj.metric == "pas":
            a = 100.0 * np.exp(a)
        v = obj.alpha * a - obj.beta * sum(o.cost[j] for o, j in zip(opts, picks)) \
            - obj.delta * sum(o.batches[j] for o, j in zip(opts, picks))
        if v > best_v:
            best_v, best = v, picks
    if best is None:
        return _infeasible(t0, "brute")
    return _mk_solution(pipe, opts, best, obj, arrival, t0, "brute")


# ---------------------------------------------------------------------------
# MILP (HiGHS — the Gurobi stand-in)
# ---------------------------------------------------------------------------
def solve_milp(pipe: PipelineModel, arrival: float,
               obj: Objective = Objective(metric="pas_prime"),
               max_replicas: int = DEFAULT_MAX_REPLICAS,
               restrict_variants=None, fixed_replicas=None,
               latency_model: str = "worst_case") -> Solution:
    from scipy import optimize as sopt
    from scipy import sparse

    t0 = time.perf_counter()
    opts = [stage_options(s, arrival, max_replicas, latency_model)
            for s in pipe.stages]
    opts = _apply_restrictions(pipe, opts, restrict_variants, fixed_replicas,
                               arrival)
    metric = obj.metric if obj.metric != "pas" else "log_pas"
    sizes = [len(o.names) for o in opts]
    n = sum(sizes)
    offs = np.cumsum([0] + sizes[:-1])

    c = np.concatenate([
        -(obj.alpha * _acc_term(o, metric)
          - obj.beta * o.cost - obj.delta * o.batches) for o in opts])
    # infeasible options: forbid via upper bound 0.  Options with an
    # infinite latency (zero-demand batches > 1) are likewise forbidden so
    # the latency rows stay finite for HiGHS.
    lat_all = np.concatenate([o.lat for o in opts])
    finite = np.isfinite(lat_all)
    ub = np.concatenate([o.feasible.astype(np.float64) for o in opts]) * finite
    lat_all = np.where(finite, lat_all, 0.0)

    rows, cols, vals = [], [], []
    for s, (o, off) in enumerate(zip(opts, offs)):
        for j in range(sizes[s]):
            rows.append(s); cols.append(off + j); vals.append(1.0)
    a_eq = sparse.coo_matrix((vals, (rows, cols)), shape=(len(opts), n))
    # one latency budget row per source->sink path (a chain has one path
    # covering every stage): sum of picked per-stage latencies <= SLA_P
    paths = pipe.paths()
    lat_rows = np.zeros((len(paths), n))
    for r, path in enumerate(paths):
        for s in path:
            off = offs[s]
            lat_rows[r, off:off + sizes[s]] = lat_all[off:off + sizes[s]]

    constraints = [
        sopt.LinearConstraint(a_eq, lb=1.0, ub=1.0),
        sopt.LinearConstraint(lat_rows, ub=pipe.sla),
    ]
    res = sopt.milp(c=c, constraints=constraints,
                    integrality=np.ones(n),
                    bounds=sopt.Bounds(lb=np.zeros(n), ub=ub))
    if not res.success or res.x is None:
        return _infeasible(t0, "milp")
    x = np.round(res.x).astype(int)
    picks = []
    for s, (o, off) in enumerate(zip(opts, offs)):
        sel = np.nonzero(x[off:off + sizes[s]])[0]
        if len(sel) != 1:
            return _infeasible(t0, "milp")
        picks.append(int(sel[0]))
    return _mk_solution(pipe, opts, picks, obj, arrival, t0, "milp")


def solve(pipe: PipelineModel, arrival: float, obj: Objective = Objective(),
          solver: str = "auto", **kw) -> Solution:
    if solver == "auto":
        combos = math.prod(len(s.variants) * len(s.batch_choices)
                           for s in pipe.stages)
        solver = "vec" if combos <= (1 << 23) else "milp"
    fn = {"vec": solve_vec, "enum": solve_enum, "brute": solve_brute,
          "milp": solve_milp}[solver]
    return fn(pipe, arrival, obj, **kw)


# ---------------------------------------------------------------------------
# cluster level: per-pipeline cost -> objective Pareto frontiers, arbitrated
# by a multiple-choice knapsack under the shared core budget
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FrontierPoint:
    """One Pareto-optimal (cost, objective) operating point of a pipeline.

    ``cost_vec``: per-device-class cost vector (aligned with the cluster's
    sorted ``device_classes``), set only by the heterogeneous frontier /
    oracle paths — the knapsack weight under per-class budgets.  ``cost``
    stays the scalar total either way."""
    cost: float                 # integer-valued: sum_s n*_s x R_m
    objective: float            # alpha*acc - beta*cost - delta*batches
    pas: float
    latency: float
    config: PipelineConfig
    cost_vec: Optional[Tuple[float, ...]] = None


def _combo_eval(pipe: PipelineModel, arrival: float, obj: Objective,
                max_replicas: int, latency_model: str,
                max_combos: int = 1 << 22,
                tables: Optional[dict] = None):
    """Vectorized evaluation of the full per-pipeline option cross-product.

    Returns (opts, feasible-combo indices as per-stage pick columns, cost,
    objective, pas) over feasible combos only.  Shared by the frontier
    builder and the brute cluster oracle.  The evaluation itself is one
    ``_broadcast_eval`` pass; only the surviving combos' per-stage pick
    columns are materialized.  ``tables``: optional ``_StageTable`` memo
    for the rate-independent half of ``stage_options``.
    """
    opts = [stage_options(s, arrival, max_replicas, latency_model,
                          tables=tables)
            for s in pipe.stages]
    sizes = [len(o.names) for o in opts]
    K = math.prod(sizes)
    if K > max_combos:
        raise ValueError(f"pipeline {pipe.name}: {K} combos exceed the "
                         f"frontier cap {max_combos}; use fewer options")
    ok, score, cost_tot, pas_val, lat_tot = _broadcast_eval(
        opts, obj, pipe.sla,
        paths=None if pipe.is_chain else pipe.paths())
    keep = np.flatnonzero(ok)
    picks = []
    radix = 1
    for j_size in sizes:
        picks.append((keep // radix) % j_size)
        radix *= j_size
    return (opts, picks, cost_tot[keep], score[keep],
            pas_val[keep], lat_tot[keep])


def _point_config(opts, picks, i) -> PipelineConfig:
    return PipelineConfig(tuple(
        StageConfig(o.names[js[i]], int(o.batches[js[i]]),
                    int(o.replicas[js[i]]), o.devices[js[i]])
        for o, js in zip(opts, picks)))


def _combo_cost_by_class(opts, picks, classes: Sequence[str]) -> np.ndarray:
    """Per-class cost columns ``(len(classes), n_combos)`` for the decoded
    combos of ``_combo_eval`` — each stage pick adds its n* x R_m to the
    row of its chosen device class."""
    n = len(picks[0]) if picks else 0
    out = np.zeros((len(classes), n))
    cidx = {c: i for i, c in enumerate(classes)}
    for o, js in zip(opts, picks):
        rows = np.array([cidx[d] for d in o.devices], dtype=np.int64)[js]
        costs = o.cost[js]
        for ci in range(len(classes)):
            mask = rows == ci
            out[ci][mask] += costs[mask]
    return out


def pareto_frontier_vec(pipe: PipelineModel, arrival: float,
                        obj: Objective, classes: Tuple[str, ...],
                        max_replicas: int = DEFAULT_MAX_REPLICAS,
                        latency_model: str = "worst_case",
                        tables: Optional[dict] = None
                        ) -> List[FrontierPoint]:
    """Vector-cost Pareto frontier of one pipeline at one rate: the
    surviving set under *strict* vector dominance — a combo dies only when
    some other combo matches or undercuts its cost in **every** device
    class and strictly beats its objective (exact ``(cost_vec, objective)``
    duplicates keep the earliest combo).  Strictness makes the prune
    invisible to the knapsack even on ties, mirroring the scalar
    discipline of ``_prune_candidates``.  Points come back in combo order
    with ``cost_vec`` set (aligned with ``classes``)."""
    opts, picks, cost, score, pas_v, lat = _combo_eval(
        pipe, arrival, obj, max_replicas, latency_model, tables=tables)
    n = len(cost)
    if n == 0:
        return []
    cvec = _combo_cost_by_class(opts, picks, classes).T    # (n, C)
    # score-descending scan (ties: earliest combo first) against the kept
    # set — kept points are mutually non-dominated, so each candidate only
    # compares against the (small) frontier built so far
    order = np.lexsort((np.arange(n), -score))
    kept: List[int] = []
    kept_cost: List[np.ndarray] = []
    kept_score: List[float] = []
    for i in order:
        ci, si = cvec[i], float(score[i])
        dominated = False
        for kc, ks in zip(kept_cost, kept_score):
            if (kc <= ci).all() and (ks > si or
                                     (ks == si and (kc == ci).all())):
                dominated = True        # strictly beaten, or exact duplicate
                break
        if dominated:
            continue
        kept.append(int(i))
        kept_cost.append(ci)
        kept_score.append(si)
    kept.sort()
    return [FrontierPoint(
        cost=float(cost[i]), objective=float(score[i]), pas=float(pas_v[i]),
        latency=float(lat[i]), config=_point_config(opts, picks, i),
        cost_vec=tuple(float(x) for x in cvec[i])) for i in kept]


def pareto_frontier(pipe: PipelineModel, arrival: float,
                    obj: Objective = Objective(),
                    max_replicas: int = DEFAULT_MAX_REPLICAS,
                    latency_model: str = "worst_case",
                    tables: Optional[dict] = None) -> List[FrontierPoint]:
    """Cost -> objective Pareto frontier of one pipeline at one rate.

    Points come back sorted by ascending cost with strictly increasing
    objective — any config off this frontier is dominated (same or less
    cost, same or better objective exists) and can never appear in an
    optimal joint allocation, which is what lets the cluster arbitration
    run a small knapsack per pipeline instead of the full cross-product.
    """
    opts, picks, cost, score, pas_v, lat = _combo_eval(
        pipe, arrival, obj, max_replicas, latency_model, tables=tables)
    if len(cost) == 0:
        return []
    order = np.lexsort((-score, cost))
    points: List[FrontierPoint] = []
    best = -np.inf
    for i in order:
        if score[i] > best + 1e-12:
            best = float(score[i])
            points.append(FrontierPoint(
                cost=float(cost[i]), objective=best, pas=float(pas_v[i]),
                latency=float(lat[i]),
                config=_point_config(opts, picks, int(i))))
    return points


class FrontierCache:
    """Cross-interval memo of per-pipeline Pareto frontiers.

    ``pareto_frontier`` is a pure function of ``(pipeline, arrival rate,
    objective, max_replicas, latency_model)``, and a policy trace revisits
    the same demand points constantly: reactive max-of-window estimators
    hold one value through many adaptation boundaries, and anti-correlated
    pipelines sit at base load most of the time.  Keying the memo on that
    exact tuple turns most per-interval frontier builds into dict hits
    while staying **bit-identical** to uncached planning (the cache
    property tests pin cached vs uncached traces config-for-config).

    Keys are hashable value objects (the frozen model dataclasses), so an
    entry can never go stale while its inputs are unchanged — the only
    invalidation semantics needed are explicit: ``clear()`` drops
    everything, and ``max_entries`` bounds memory by FIFO eviction.
    Passing ``cache=None`` to the solvers (or
    ``frontier_cache=None`` to ``adapter.run_cluster_trace``) bypasses
    caching entirely — the A/B knob the benchmarks use.

    ``quantize``: optional rate-bucket width.  When set, the rate the
    frontier is *computed at* snaps to ``round(lam / quantize) *
    quantize``, so nearby rates share one frontier — more hits, but the
    planning becomes approximate (deterministically so: the plan depends
    only on the bucketed rate, never on cache state).  The default
    ``None`` keys on the exact rate.
    """

    __slots__ = ("quantize", "max_entries", "hits", "misses", "_tab")

    def __init__(self, quantize: Optional[float] = None,
                 max_entries: int = 4096):
        if quantize is not None and quantize <= 0:
            raise ValueError("quantize must be positive")
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.quantize = quantize
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self._tab: dict = {}

    def __len__(self) -> int:
        return len(self._tab)

    def rate_of(self, arrival: float) -> float:
        """The (possibly bucketed) rate a frontier is computed/keyed at."""
        if self.quantize is None:
            return float(arrival)
        return round(float(arrival) / self.quantize) * self.quantize

    def frontier(self, pipe: PipelineModel, arrival: float, obj: Objective,
                 max_replicas: int = DEFAULT_MAX_REPLICAS,
                 latency_model: str = "worst_case",
                 classes: Optional[Tuple[str, ...]] = None
                 ) -> List[FrontierPoint]:
        """Memoized ``pareto_frontier`` (or, with ``classes``, the
        vector-cost ``pareto_frontier_vec`` keyed on the class axis too) —
        callers must treat the returned list as immutable (it is shared
        across hits)."""
        lam = self.rate_of(arrival)
        key = ((pipe, lam, obj, max_replicas, latency_model)
               if classes is None
               else (pipe, lam, obj, max_replicas, latency_model, classes))
        pts = self._tab.get(key)
        if pts is not None:
            self.hits += 1
            return pts
        self.misses += 1
        tables = self._stage_tables()
        if classes is None:
            pts = pareto_frontier(pipe, lam, obj, max_replicas,
                                  latency_model, tables=tables)
        else:
            pts = pareto_frontier_vec(pipe, lam, obj, classes, max_replicas,
                                      latency_model, tables=tables)
        if len(self._tab) >= self.max_entries:
            self._tab.pop(next(iter(self._tab)))
        self._tab[key] = pts
        return pts

    def _stage_tables(self) -> Optional[dict]:
        """Rate-independent ``_StageTable`` memo for frontier builds —
        ``None`` here (exact legacy build path); ``PlannerCache`` overrides
        with its table store."""
        return None

    def clear(self) -> None:
        self._tab.clear()

    # --- pickling -------------------------------------------------------
    # ``__slots__`` classes need explicit state hooks; the sweep harness
    # ships warm caches across process boundaries (and its tests pin the
    # round-trip), so keep this an API promise rather than an accident.
    # Entries are value objects (frozen model dataclasses -> FrontierPoint
    # lists), so the whole table pickles as-is.
    def __getstate__(self):
        return {"quantize": self.quantize, "max_entries": self.max_entries,
                "hits": self.hits, "misses": self.misses, "tab": self._tab}

    def __setstate__(self, state):
        self.quantize = state["quantize"]
        self.max_entries = state["max_entries"]
        self.hits = state["hits"]
        self.misses = state["misses"]
        self._tab = state["tab"]

    @property
    def stats(self) -> dict:
        """Hit/miss counters for bench observability."""
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._tab),
                "hit_rate": round(self.hits / total, 4) if total else 0.0}

    def stats_snapshot(self) -> Tuple[int, int]:
        """Opaque counter snapshot for ``stats_since`` (hits, misses)."""
        return (self.hits, self.misses)

    def stats_since(self, snapshot: Tuple[int, int]) -> dict:
        """Hit/miss delta since a ``stats_snapshot()``.

        The sweep harness keeps one warm cache per worker process across
        all the cells that worker drains, so the *cumulative* ``stats``
        conflate every cell the worker has seen; the per-cell delta is
        what makes a cache-cold policy diagnosable from its own record.
        """
        h0, m0 = snapshot
        dh, dm = self.hits - h0, self.misses - m0
        total = dh + dm
        return {"hits": dh, "misses": dm, "entries": len(self._tab),
                "hit_rate": round(dh / total, 4) if total else 0.0}


_UNSET = object()


class PlannerCache(FrontierCache):
    """The incremental planning layer: a ``FrontierCache`` plus every memo
    the cross-interval ``solve_cluster`` fast path needs, all exact-keyed
    on value objects (the same discipline as the frontier memo) so every
    path is **bit-identical** to planning without it (property-tested
    against ``cache=None`` across switch costs, switch budgets, overlap
    charging and hetero vector costs).

    What it adds over the plain frontier memo:

    * ``_stage_tab`` — rate-independent ``_StageTable`` columns per stage,
      so a frontier build at a *new* rate (the dominant cost of a decision
      boundary once frontiers repeat) only runs the n*/feasibility
      arithmetic instead of re-walking the model objects.
    * ``_eval_tab`` — ``evaluate_config`` memo for the incumbent/revert
      stay candidates (keyed on the exact (pipe, config, rate, objective,
      latency model, classes) tuple).
    * ``_prune_tab`` — dominance-pruned knapsack candidate tables keyed on
      the exact candidate values, shared across solves whose tab repeats.
    * ``_sol_tab`` — whole-``solve_cluster`` memo keyed on every solve
      input; a boundary whose demand estimates and incumbent both held
      returns the previous solution outright.
    * ``_dp_state`` — the incumbent knapsack DP (per-pipeline dp rows and
      pick tables).  The next solve detects which pipelines' candidate
      tabs actually changed and resumes the DP after the longest unchanged
      *prefix*; the DP processes pipelines in order, so a prefix with
      identical tabs provably reproduces identical dp/pick rows (same
      float ops in the same order) and only the changed suffix re-solves
      against the inherited dp vector (the residual-budget view of the
      prefix).  A change in the first pipeline, a different budget grid or
      a different switch budget can't prove any reuse — those fall back to
      the full DP from scratch.  Either way the backtrack runs over the
      same pick tables a cold solve would produce: bit-identical, not
      merely equal-objective.

    Counters (`sol_hits`/`sol_misses`, `dp_prefix_pipes`, `dp_full_hits`)
    surface in ``stats`` for bench observability.  The DP state is
    volatile and intentionally not pickled (the sweep harness ships warm
    caches across processes; the memo dicts travel, the incumbent DP does
    not)."""

    __slots__ = ("_stage_tab", "_eval_tab", "_prune_tab", "_sol_tab",
                 "_dp_state", "sol_hits", "sol_misses", "dp_prefix_pipes",
                 "dp_full_hits")

    def __init__(self, quantize: Optional[float] = None,
                 max_entries: int = 4096):
        super().__init__(quantize, max_entries)
        self._stage_tab: dict = {}
        self._eval_tab: dict = {}
        self._prune_tab: dict = {}
        self._sol_tab: dict = {}
        self._dp_state: Optional[dict] = None
        self.sol_hits = 0
        self.sol_misses = 0
        self.dp_prefix_pipes = 0
        self.dp_full_hits = 0

    def _stage_tables(self) -> Optional[dict]:
        return self._stage_tab

    def eval_config(self, pipe, config, arrival, obj, latency_model,
                    classes):
        """Memoized ``evaluate_config`` (including ``None`` results)."""
        key = (pipe, config, float(arrival), obj, latency_model, classes)
        out = self._eval_tab.get(key, _UNSET)
        if out is _UNSET:
            out = evaluate_config(pipe, config, arrival, obj, latency_model,
                                  classes)
            if len(self._eval_tab) >= self.max_entries:
                self._eval_tab.pop(next(iter(self._eval_tab)))
            self._eval_tab[key] = out
        return out

    def clear(self) -> None:
        super().clear()
        self._stage_tab.clear()
        self._eval_tab.clear()
        self._prune_tab.clear()
        self._sol_tab.clear()
        self._dp_state = None

    def __getstate__(self):
        state = super().__getstate__()
        state.update(stage_tab=self._stage_tab, eval_tab=self._eval_tab,
                     prune_tab=self._prune_tab, sol_tab=self._sol_tab,
                     sol_hits=self.sol_hits, sol_misses=self.sol_misses,
                     dp_prefix_pipes=self.dp_prefix_pipes,
                     dp_full_hits=self.dp_full_hits)
        return state

    def __setstate__(self, state):
        super().__setstate__(state)
        self._stage_tab = state.get("stage_tab", {})
        self._eval_tab = state.get("eval_tab", {})
        self._prune_tab = state.get("prune_tab", {})
        self._sol_tab = state.get("sol_tab", {})
        self._dp_state = None
        self.sol_hits = state.get("sol_hits", 0)
        self.sol_misses = state.get("sol_misses", 0)
        self.dp_prefix_pipes = state.get("dp_prefix_pipes", 0)
        self.dp_full_hits = state.get("dp_full_hits", 0)

    @property
    def stats(self) -> dict:
        out = FrontierCache.stats.fget(self)
        total = self.sol_hits + self.sol_misses
        out["planner"] = {
            "sol_hits": self.sol_hits, "sol_misses": self.sol_misses,
            "sol_hit_rate": round(self.sol_hits / total, 4) if total
            else 0.0,
            "dp_prefix_pipes": self.dp_prefix_pipes,
            "dp_full_hits": self.dp_full_hits,
            "stage_tables": len(self._stage_tab),
        }
        return out


def _frontier(pipe: PipelineModel, arrival: float, obj: Objective,
              max_replicas: int, latency_model: str,
              cache: Optional[FrontierCache],
              classes: Optional[Tuple[str, ...]] = None
              ) -> List[FrontierPoint]:
    if cache is not None:
        return cache.frontier(pipe, arrival, obj, max_replicas,
                              latency_model, classes)
    if classes is None:
        return pareto_frontier(pipe, arrival, obj, max_replicas,
                               latency_model)
    return pareto_frontier_vec(pipe, arrival, obj, classes, max_replicas,
                               latency_model)


def solve_capped(pipe: PipelineModel, arrival: float,
                 obj: Objective = Objective(), cost_cap: float = np.inf,
                 max_replicas: int = DEFAULT_MAX_REPLICAS,
                 latency_model: str = "worst_case",
                 cache: Optional[FrontierCache] = None,
                 classes: Optional[Tuple[str, ...]] = None) -> Solution:
    """Best per-pipeline config whose cost fits ``cost_cap`` (the
    static-split baselines' per-pipeline sub-problem).  ``cache``: an
    optional ``FrontierCache`` memoizing the frontier build.  With
    ``classes``, ``cost_cap`` is a per-class cap vector aligned with it
    and the frontier carries vector costs — the per-class static split's
    sub-problem."""
    t0 = time.perf_counter()
    if classes is not None:
        pts = [p for p in _frontier(pipe, arrival, obj, max_replicas,
                                    latency_model, cache, classes)
               if all(cv <= cap + 1e-9
                      for cv, cap in zip(p.cost_vec, cost_cap))]
        if not pts:
            return _infeasible(t0, "capped")
        best = max(pts, key=lambda p: p.objective)  # first-wins on ties
        return Solution(best.config, best.objective, best.pas, best.cost,
                        best.latency, time.perf_counter() - t0, True,
                        "capped")
    pts = [p for p in _frontier(pipe, arrival, obj, max_replicas,
                                latency_model, cache)
           if p.cost <= cost_cap + 1e-9]
    if not pts:
        return _infeasible(t0, "capped")
    best = pts[-1]                       # frontier objective is increasing
    return Solution(best.config, best.objective, best.pas, best.cost,
                    best.latency, time.perf_counter() - t0, True, "capped")


@dataclasses.dataclass
class ClusterSolution:
    """Joint allocation: one frontier point per pipeline under sum(cost) <= C.

    ``objective`` is the arbitration score: the SLA-weighted sum of
    per-pipeline objectives minus ``switch_cost`` per *charged* switch.
    ``n_switches`` is that charged count (0 when no incumbent was given):
    pipelines whose chosen config differs from the committed incumbent and
    — when a serving config was given — from the still-serving config,
    whose re-proposal is a free cancel of the pending rollout.
    """
    config: Optional["ClusterConfig"]
    per_pipeline: List[Solution]
    objective: float                     # summed alpha*PAS - beta*cost - ...
    cost: float
    feasible: bool
    solve_time: float
    solver: str
    n_switches: int = 0

    @property
    def pas_values(self) -> List[float]:
        return [s.pas for s in self.per_pipeline]


def _cluster_solution(cluster, chosen: List[FrontierPoint], t0, solver,
                      weights: Optional[Sequence[float]] = None,
                      current=None, switch_cost: float = 0.0,
                      serving=None):
    from repro_torch.core.cluster import ClusterConfig
    sols = [Solution(p.config, p.objective, p.pas, p.cost, p.latency,
                     0.0, True, solver) for p in chosen]
    cfg = ClusterConfig(tuple(p.config for p in chosen))
    if weights is None:
        weights = [1.0] * len(chosen)
    n_switches = _charged_switches(chosen, current, serving)
    objective = sum(w * p.objective for w, p in zip(weights, chosen)) \
        - switch_cost * n_switches
    return ClusterSolution(
        config=cfg, per_pipeline=sols,
        objective=float(objective),
        cost=float(sum(p.cost for p in chosen)),
        feasible=True, solve_time=time.perf_counter() - t0, solver=solver,
        n_switches=n_switches)


def _cluster_infeasible(cluster, t0, solver):
    return ClusterSolution(None, [], -np.inf, 0.0, False,
                           time.perf_counter() - t0, solver)


def _charged_switches(chosen: Sequence[FrontierPoint], current,
                      serving) -> int:
    """Switches that cost something: the chosen config differs from the
    committed incumbent AND — mid-window — from the still-serving config
    (re-proposing the serving config is a free cancel in the simulator:
    no new adaptation window, no reconfiguration counted)."""
    if current is None:
        return 0
    return sum(
        1 for i, p in enumerate(chosen)
        if p.config != current.pipelines[i]
        and (serving is None or p.config != serving.pipelines[i]))


def evaluate_config(pipe: PipelineModel, config: PipelineConfig,
                    arrival: float, obj: Objective = Objective(),
                    latency_model: str = "worst_case",
                    classes: Optional[Tuple[str, ...]] = None
                    ) -> Optional[FrontierPoint]:
    """Score one explicit ``PipelineConfig`` at a rate, or ``None`` when it
    cannot carry that rate (throughput 10c or the SLA 10b fails).

    This is how the cluster's *incumbent* config enters the switch-aware
    knapsack: the held config generally sits off the frontier built at the
    new rate (its replica counts were sized for the old rate), so it must
    be evaluated explicitly to become the zero-penalty "stay" candidate.
    """
    if not config.supports(pipe, arrival):
        return None
    lat = float(config.latency(pipe, arrival, latency_model))
    if lat > pipe.sla:
        return None
    # score through the same per-stage terms as _acc_term/_combine_acc so
    # the incumbent stay candidate is priced through the identical float
    # path as the frontier challengers it competes against in the knapsack
    accs = np.array([st.variant(sc.variant).acc(sc.device)
                     for sc, st in zip(config.stages, pipe.stages)])
    pas_log = np.log(np.maximum(accs, 1e-9) / 100.0)
    if obj.metric == "pas_prime":
        acc = ACC.pas_prime_of(config, pipe)  # same sums as acc_norm terms
    elif obj.metric in ("pas", "log_pas"):
        acc = _combine_acc(float(np.sum(pas_log)), obj.metric)
    else:
        raise ValueError(obj.metric)
    pas_val = 100.0 * float(np.exp(np.sum(pas_log)))
    cost = config.cost(pipe)
    bat = sum(sc.batch for sc in config.stages)
    objective = obj.alpha * acc - obj.beta * cost - obj.delta * bat
    cost_vec = (tuple(config.cost_by_class(pipe, classes))
                if classes is not None else None)
    return FrontierPoint(cost=float(cost), objective=float(objective),
                         pas=pas_val, latency=lat, config=config,
                         cost_vec=cost_vec)


@dataclasses.dataclass(frozen=True)
class _Candidate:
    """One knapsack choice for a pipeline: an operating point with its
    SLA-weighted, switch-penalized arbitration value.  ``cost`` is the
    knapsack *weight* — the transition charge ``max(old, new)`` under
    overlap-aware arbitration, which can exceed the operating point's own
    steady-state cost (``point.cost``).  Under per-class budgets it is a
    per-class int tuple (overlap maxes taken elementwise) instead of a
    scalar int."""
    cost: object                # int, or Tuple[int, ...] per device class
    value: float
    switch: bool
    point: FrontierPoint


def _switch_candidates(frontier: List[FrontierPoint],
                       incumbent: Optional[FrontierPoint],
                       weight: float, switch_cost: float,
                       old_cost=None,
                       revert: Optional[FrontierPoint] = None,
                       vector: bool = False) -> List[_Candidate]:
    """Frontier points (penalized unless they are free, below) plus the
    incumbent itself as the zero-penalty stay option when it is feasible at
    the new rate but off the frontier.  Frontier domination is preserved:
    the penalty is constant across all switch candidates, so any off-
    frontier *switch* stays dominated — only the free options need
    injecting.

    Free (unpenalized, no switch-budget slot) candidates match what the
    simulator executes without starting a new adaptation window: the
    committed incumbent (a hold is a no-op) and — mid-window only —
    ``revert``, the still-serving old config (re-proposing it cancels the
    pending rollout for free in ``ClusterSimulator.reconfigure_pipeline``).

    ``old_cost`` (overlap-aware arbitration): the cores the pipeline's
    currently *serving* fleet holds.  When given, every candidate's
    knapsack weight becomes ``max(old_cost, candidate cost)`` — during the
    §5.3 adaptation window the old fleet serves while the new one is
    provisioned, so the budget must admit the larger of the two.  The
    transform is monotone in cost, so frontier domination still holds.

    ``vector`` (per-class budgets): knapsack weights are per-class int
    tuples taken from each point's ``cost_vec``, and the overlap charge is
    the *elementwise* max against the serving fleet's per-class holdings —
    elementwise max is monotone per class, so vector domination survives
    the transform just like the scalar case."""
    inc_cfg = incumbent.config if incumbent is not None else None
    rev_cfg = revert.config if revert is not None else None

    def knap_cost(p: FrontierPoint):
        if vector:
            c = tuple(int(round(x)) for x in p.cost_vec)
            return c if old_cost is None else tuple(
                max(a, b) for a, b in zip(c, old_cost))
        c = int(round(p.cost))
        return c if old_cost is None else max(c, old_cost)

    cands = []
    seen_incumbent = seen_revert = False
    for p in frontier:
        stay = inc_cfg is not None and p.config == inc_cfg
        rev = rev_cfg is not None and p.config == rev_cfg
        seen_incumbent = seen_incumbent or stay
        seen_revert = seen_revert or rev
        free = stay or rev
        cands.append(_Candidate(knap_cost(p),
                                weight * p.objective
                                - (0.0 if free else switch_cost),
                                not free, p))
    if inc_cfg is not None and not seen_incumbent:
        cands.append(_Candidate(knap_cost(incumbent),
                                weight * incumbent.objective, False,
                                incumbent))
    if rev_cfg is not None and not seen_revert:
        cands.append(_Candidate(knap_cost(revert),
                                weight * revert.objective, False,
                                revert))
    return cands


def _overlap_old_costs(cluster, current, overlap: bool, serving,
                       classes: Optional[Tuple[str, ...]] = None
                       ) -> Optional[list]:
    """Per-pipeline cores held by the currently *serving* fleets, for the
    overlap-aware transition charge — ``None`` when overlap arbitration is
    off (no ``overlap`` flag or no incumbent to overlap with).  ``serving``
    defaults to ``current``; they differ only while an adaptation window is
    already in flight at decision time.  With ``classes`` each entry is a
    per-class int tuple (the per-class holdings the elementwise-max overlap
    charge is taken against) instead of a scalar."""
    if not overlap or current is None:
        return None
    serving_cfg = serving if serving is not None else current
    if len(serving_cfg.pipelines) != len(cluster.pipelines):
        raise ValueError("serving config/cluster pipeline count mismatch")
    if classes is not None:
        return [tuple(int(round(x)) for x in cfg.cost_by_class(pipe, classes))
                for cfg, pipe in zip(serving_cfg.pipelines, cluster.pipelines)]
    return [int(round(cfg.cost(pipe)))
            for cfg, pipe in zip(serving_cfg.pipelines, cluster.pipelines)]


def _resolve_weights(cluster, sla_weights) -> List[float]:
    if sla_weights is None:
        w = getattr(cluster, "weights", None)
        return list(w) if w is not None else [1.0] * len(cluster.pipelines)
    if len(sla_weights) != len(cluster.pipelines):
        raise ValueError("one SLA weight per pipeline required")
    return [float(w) for w in sla_weights]


def _remember(plan: Optional["PlannerCache"], skey, sol):
    """Store a finished solve in the planner's whole-solve memo (FIFO
    capped).  Infeasible solutions are remembered too — re-asking the same
    impossible question is just as common at a flapping boundary."""
    if plan is not None and skey is not None:
        if len(plan._sol_tab) >= plan.max_entries:
            plan._sol_tab.pop(next(iter(plan._sol_tab)))
        plan._sol_tab[skey] = sol
    return sol


def solve_cluster(cluster, arrivals: Sequence[float],
                  obj: Objective = Objective(),
                  budget: Optional[float] = None,
                  max_replicas: int = DEFAULT_MAX_REPLICAS,
                  latency_model: str = "worst_case",
                  current=None,
                  switch_cost: float = 0.0,
                  switch_budget: Optional[int] = None,
                  sla_weights: Optional[Sequence[float]] = None,
                  overlap: bool = False,
                  serving=None,
                  cache: Optional[FrontierCache] = None
                  ) -> ClusterSolution:
    """Joint arbitration: pick one frontier point per pipeline maximizing
    the SLA-weighted summed objective under ``sum(cost) <= budget``
    (default: the cluster's core budget C).

    This is the single place the cluster knobs are documented; the adapter
    (``adapter.run_cluster_trace``) and the joint policy
    (``baselines.cluster_ipa``) forward them here verbatim.

    Switch-cost awareness (paper §5.3: each reconfiguration costs ~8 s of
    transition during which the old config keeps serving): when ``current``
    (the incumbent ``ClusterConfig``) is given, every candidate that
    differs from a pipeline's held config is charged ``switch_cost``
    (objective units — the §5.3 adaptation overhead expressed as lost
    objective), and ``switch_budget`` caps how many pipelines may change
    per interval.  The incumbent enters the candidate set as a zero-penalty
    "stay" option whenever it can still carry the new rate — hysteresis
    falls out of the arithmetic: a challenger must beat the incumbent by
    more than its own transition cost to be picked.  ``sla_weights``
    multiplies each pipeline's objective in the knapsack (default: the
    cluster's own ``sla_weights``, else 1.0) — INFaaS-style workload
    importance.

    Transition-overlap awareness (``overlap=True``, requires ``current``):
    during the adaptation window a changed pipeline's *old* replica fleet
    keeps serving while the new one is provisioned, so the pipeline
    transiently holds ``max(old, new)`` cores, not ``new``.  With overlap
    on, every candidate's knapsack weight becomes that transition charge
    (old cost taken from ``serving`` — the config actually serving right
    now, which mid-window differs from the committed ``current`` — default
    ``current``), making overlapping grants of a downsizer's freed cores
    inadmissible *at decision time* instead of transiently violating the
    shared budget mid-window.  The reported ``ClusterSolution.cost`` stays
    the steady-state (post-transition) cost; only admissibility changes.
    ``overlap`` without ``current`` is a no-op (nothing old to overlap
    with), and the adapter only sets it when ``adaptation_delay > 0`` —
    at zero delay there is no window and the non-overlap path is
    bit-for-bit the PR 3 solver.

    Passing ``serving`` explicitly also prices the mid-window *revert*
    correctly: a pipeline's still-serving config (when it differs from the
    committed incumbent) enters as a second free candidate — no
    ``switch_cost``, no ``switch_budget`` slot — because re-proposing it
    cancels the pending rollout in the simulator without starting a new
    adaptation window.  ``n_switches`` counts only *charged* switches
    (differs from both the incumbent and the serving config).

    Costs are integral (replicas x base allocation), so the multiple-choice
    knapsack runs as an exact DP over budgets 0..C: processing pipelines in
    order, ``dp[b]`` is the best summed value of a prefix fitting in ``b``
    cores.  With a switch budget the DP gains a second exact dimension,
    ``dp[k][b]`` = best value using exactly ``k`` switches.  With
    ``switch_cost == 0``, no switch budget and ``overlap=False`` the path
    is the PR 2 DP bit-for-bit (weights of 1.0 multiply exactly).  All
    paths are validated against the ``solve_cluster_brute`` cross-product
    oracle in the property tests.

    ``cache``: an optional ``FrontierCache`` memoizing the per-pipeline
    frontier builds across calls (the dominant cost when rates repeat
    across adaptation intervals).  With exact keying (the default cache
    construction) results are bit-identical to ``cache=None``.  Passing a
    ``PlannerCache`` (the adapter's default) additionally memoizes whole
    solves on their exact inputs, the incumbent evaluations, and the
    knapsack DP's unchanged pipeline prefix across consecutive calls —
    every layer keyed on exact values, so still bit-identical to
    ``cache=None`` (property-tested in ``tests/test_incremental.py``).

    Heterogeneous clusters (``cluster.is_hetero``): the frontier carries
    vector costs, the knapsack runs over the per-class budget grid
    (``_knapsack_nd``), and ``budget`` may be a per-class mapping
    (default: the cluster's own ``class_budgets``) — a bare scalar budget
    is ambiguous there and rejected.  With a single class everything below
    degenerates to the scalar path bit-for-bit.
    """
    t0 = time.perf_counter()
    hetero = bool(getattr(cluster, "is_hetero", False))
    classes = cluster.device_classes if hetero else None
    if budget is None:
        budgets = cluster.budget_vector if hetero else None
        budget = cluster.cores
    elif hetero:
        if not isinstance(budget, Mapping):
            raise ValueError("heterogeneous cluster needs a per-class "
                             "budget mapping, not a scalar")
        budgets = tuple(float(budget.get(c, 0.0)) for c in classes)
    weights = _resolve_weights(cluster, sla_weights)
    if current is not None and len(current.pipelines) != len(cluster.pipelines):
        raise ValueError("current config/cluster pipeline count mismatch")
    plan = cache if isinstance(cache, PlannerCache) else None
    skey = None
    if plan is not None:
        skey = (tuple(cluster.pipelines), classes,
                budgets if hetero else float(budget), tuple(weights), obj,
                int(max_replicas), latency_model,
                None if current is None else tuple(current.pipelines),
                float(switch_cost),
                None if switch_budget is None else int(switch_budget),
                bool(overlap),
                None if serving is None else tuple(serving.pipelines),
                tuple(float(a) for a in arrivals))
        hit = plan._sol_tab.get(skey, _UNSET)
        if hit is not _UNSET:
            plan.sol_hits += 1
            return dataclasses.replace(
                hit, solve_time=time.perf_counter() - t0)
        plan.sol_misses += 1
    frontiers = [_frontier(p, lam, obj, max_replicas, latency_model, cache,
                           classes)
                 for p, lam in zip(cluster.pipelines, arrivals)]
    if any(not f for f in frontiers):
        return _remember(plan, skey,
                         _cluster_infeasible(cluster, t0, "cluster_knap"))

    old_costs = _overlap_old_costs(cluster, current, overlap, serving,
                                   classes)
    track_switches = current is not None and (switch_cost > 0.0
                                              or switch_budget is not None
                                              or old_costs is not None)
    if not track_switches:
        return _remember(plan, skey, _solve_cluster_plain(
            cluster, frontiers, weights, budgets if hetero else budget,
            current, t0, hetero, plan))

    serving_cfg = serving                 # current is not None here
    if serving_cfg is not None and \
            len(serving_cfg.pipelines) != len(cluster.pipelines):
        raise ValueError("serving config/cluster pipeline count mismatch")
    ev = evaluate_config if plan is None else plan.eval_config
    incumbents = [ev(pipe, cfg, lam, obj, latency_model, classes)
                  for pipe, cfg, lam in zip(cluster.pipelines,
                                            current.pipelines, arrivals)]
    # mid-window free-revert candidates: the still-serving config, whose
    # re-proposal cancels the pending rollout for free in the simulator
    reverts: List[Optional[FrontierPoint]] = [None] * len(cluster.pipelines)
    if serving_cfg is not None:
        reverts = [ev(pipe, scfg, lam, obj, latency_model, classes)
                   if scfg != ccfg else None
                   for pipe, scfg, ccfg, lam
                   in zip(cluster.pipelines, serving_cfg.pipelines,
                          current.pipelines, arrivals)]
    cand_tabs = [_switch_candidates(
        f, inc, w, switch_cost,
        old_costs[i] if old_costs is not None else None, reverts[i],
        vector=hetero)
        for i, (f, inc, w) in enumerate(zip(frontiers, incumbents, weights))]
    if hetero:
        chosen = _knapsack_nd(
            cand_tabs, budgets,
            min(int(switch_budget), len(cand_tabs))
            if switch_budget is not None else None, plan=plan)
    elif switch_budget is None:
        chosen = _knapsack_1d(cand_tabs, budget, plan=plan)
    else:
        chosen = _knapsack_2d(cand_tabs, budget,
                              min(int(switch_budget), len(cand_tabs)),
                              plan=plan)
    if chosen is None:
        return _remember(plan, skey,
                         _cluster_infeasible(cluster, t0, "cluster_knap"))
    return _remember(plan, skey, _cluster_solution(
        cluster, [c.point for c in chosen], t0, "cluster_knap", weights,
        current, switch_cost, serving_cfg))


def _solve_cluster_plain(cluster, frontiers, weights, budget, current, t0,
                         hetero: bool = False,
                         plan: Optional["PlannerCache"] = None):
    """The PR 2 exact 1-D knapsack (no switch dimension).  Weighted values
    only — with weights of 1.0 this is bit-identical to the unweighted DP
    (IEEE multiplication by 1.0 is exact, and ``_knapsack_1d`` runs the
    same candidate order, float operations and tie-breaking).  ``hetero``:
    ``budget`` is the per-class budget vector and the DP runs on the
    budget grid instead."""
    if hetero:
        cand_tabs = [[_Candidate(tuple(int(round(x)) for x in p.cost_vec),
                                 w * p.objective, False, p)
                      for p in f] for f, w in zip(frontiers, weights)]
        chosen = _knapsack_nd(cand_tabs, budget, plan=plan)
    else:
        cand_tabs = [[_Candidate(int(round(p.cost)), w * p.objective,
                                 False, p)
                      for p in f] for f, w in zip(frontiers, weights)]
        chosen = _knapsack_1d(cand_tabs, budget, plan=plan)
    if chosen is None:
        return _cluster_infeasible(cluster, t0, "cluster_knap")
    return _cluster_solution(cluster, [c.point for c in chosen], t0,
                             "cluster_knap", weights, current)


def _prune_candidates(cands: List[_Candidate],
                      cross_class: bool) -> List[_Candidate]:
    """Dominance pruning for one pipeline's knapsack tab: drop every
    candidate some other candidate *strictly* beats in value at no higher
    knapsack cost, plus exact ``(cost, value)`` duplicates (first kept).

    The strictness discipline makes pruning invisible, not merely
    objective-preserving: in the DP a strict dominator's total beats the
    dominated candidate's at every budget (``dp`` is monotone in budget),
    so the dominated row could never be picked — even on ties.  In the
    2-D exactly-k DP that argument only holds within a switch class
    (stay/switch draw from different ``k`` rows), so callers pass
    ``cross_class=False`` there and domination never crosses classes.

    This is where overlap-aware arbitration's frontier collapse pays off:
    ``max(old_cost, cost)`` maps every candidate at or below the serving
    fleet's cost onto one knapsack column, and all but the best of them
    die here instead of each burning an O(C) DP row."""
    n = len(cands)
    if n <= 1:
        return cands
    costs = np.array([c.cost for c in cands], dtype=np.int64)
    vals = np.array([c.value for c in cands])
    sw = np.array([c.switch for c in cands], dtype=bool)

    def prefix_best(mask: np.ndarray) -> np.ndarray:
        """Per candidate: the best value among masked candidates with
        cost <= its cost (-inf when none)."""
        if not mask.any():
            return np.full(n, -np.inf)
        order = np.argsort(costs[mask], kind="stable")
        mc = costs[mask][order]
        cm = np.maximum.accumulate(vals[mask][order])
        idx = np.searchsorted(mc, costs, side="right") - 1
        return np.where(idx >= 0, cm[np.maximum(idx, 0)], -np.inf)

    if cross_class:
        dominated = prefix_best(np.ones(n, dtype=bool)) > vals
    else:
        best_stay = prefix_best(~sw)
        best_switch = prefix_best(sw)
        dominated = np.where(sw, best_switch, best_stay) > vals
    seen = set()
    out = []
    for i, c in enumerate(cands):
        if dominated[i]:
            continue
        key = (c.cost, c.value) if cross_class else (c.cost, c.value,
                                                     c.switch)
        if key in seen:
            continue
        seen.add(key)
        out.append(c)
    return out


def _tab_key(cands: List[_Candidate]) -> tuple:
    """Exact value key of one pipeline's (unpruned) knapsack tab.  The DP
    is a pure function of these values, so equal keys across solves mean
    equal dp/pick rows bit-for-bit — the reuse test of the incremental
    solve path."""
    return tuple((c.cost, c.value, c.switch, c.point) for c in cands)


def _dp_prefix(plan: Optional["PlannerCache"], gkey: tuple,
               tab_keys: List[tuple]):
    """Longest prefix of the incumbent DP state reusable for this solve:
    the stored global key (DP flavor + budget grid + switch budget) must
    match exactly, then pipelines match in order until the first changed
    tab.  Returns ``(start, state)`` with ``state=None`` when nothing is
    reusable."""
    if plan is None:
        return 0, None
    st = plan._dp_state
    if st is None or st["gkey"] != gkey:
        return 0, None
    start = 0
    for a, b in zip(st["tab_keys"], tab_keys):
        if a != b:
            break
        start += 1
    plan.dp_prefix_pipes += start
    return start, st


def _pruned_memo(plan: Optional["PlannerCache"], key: tuple,
                 cands: List[_Candidate], cross_class: bool,
                 vec: bool) -> List[_Candidate]:
    """Memoized dominance pruning (pruning is a pure function of the tab
    values, so sharing the pruned list across solves is invisible)."""
    prune = _prune_candidates_vec if vec else _prune_candidates
    if plan is None:
        return prune(cands, cross_class)
    mkey = (key, cross_class)
    out = plan._prune_tab.get(mkey)
    if out is None:
        out = prune(cands, cross_class)
        if len(plan._prune_tab) >= plan.max_entries:
            plan._prune_tab.pop(next(iter(plan._prune_tab)))
        plan._prune_tab[mkey] = out
    return out


def _knapsack_1d(cand_tabs: List[List[_Candidate]], budget: float,
                 plan: Optional["PlannerCache"] = None
                 ) -> Optional[List[_Candidate]]:
    """Exact multiple-choice knapsack over pre-valued candidates (switch
    penalties already folded into ``value``).  Dominated rows are pruned
    first, and each pipeline's DP row only sweeps the budget columns its
    prefix can actually reach (``hi``) — the flat tail beyond is one
    broadcast fill, not per-candidate vector work.

    ``plan``: optional ``PlannerCache`` carrying the incumbent DP.  The
    solve resumes after the longest prefix of pipelines whose candidate
    tabs are value-identical to the incumbent's (their stored dp/pick rows
    are exactly what recomputing would produce), re-running only the
    changed suffix; bit-identical to the cold DP by construction."""
    if not np.isfinite(budget):
        return [max(cands, key=lambda c: c.value) for cands in cand_tabs]
    B = int(np.floor(budget + 1e-9))
    n = len(cand_tabs)
    tab_keys = [_tab_key(c) for c in cand_tabs] if plan is not None else []
    start, st = _dp_prefix(plan, ("1d", B), tab_keys)
    if st is not None and start == n == len(st["tab_keys"]):
        plan.dp_full_hits += 1
        ch = st["chosen"]
        return None if ch is None else list(ch)
    if start:
        pruned = list(st["pruned"][:start])
        pick_tabs = list(st["pick_tabs"][:start])
        dp_list = list(st["dp_list"][:start])
        hi_list = list(st["hi_list"][:start])
        dp, hi = dp_list[-1], hi_list[-1]
    else:
        pruned, pick_tabs, dp_list, hi_list = [], [], [], []
        dp = np.zeros(B + 1)
        hi = 0                           # reachable-cost bound so far
    for i in range(start, n):
        cands = _pruned_memo(plan, tab_keys[i] if plan is not None else (),
                             cand_tabs[i], cross_class=True, vec=False)
        pruned.append(cands)
        cur = np.full(B + 1, -np.inf)
        pick = np.full(B + 1, -1, dtype=np.int64)
        step = max((c.cost for c in cands if c.cost <= B), default=0)
        hi = min(B, hi + step)
        for j, c in enumerate(cands):
            if c.cost > B:
                continue
            cand = dp[:hi + 1 - c.cost] + c.value
            seg = cur[c.cost:hi + 1]
            sel = pick[c.cost:hi + 1]
            better = cand > seg
            seg[better] = cand[better]
            sel[better] = j
        if hi < B:                       # flat tail: nothing costs more
            cur[hi + 1:] = cur[hi]
            pick[hi + 1:] = pick[hi]
        pick_tabs.append(pick)
        dp_list.append(cur)
        hi_list.append(hi)
        dp = cur
    chosen = _backtrack_1d(pruned, pick_tabs, dp, B)
    if plan is not None:
        plan._dp_state = {
            "gkey": ("1d", B), "tab_keys": tab_keys, "pruned": pruned,
            "dp_list": dp_list, "hi_list": hi_list, "pick_tabs": pick_tabs,
            "chosen": None if chosen is None else tuple(chosen)}
    return chosen


def _backtrack_1d(pruned, pick_tabs, dp, B):
    if not np.isfinite(dp[B] if len(pick_tabs) else 0.0):
        return None
    b = B
    chosen_rev: List[_Candidate] = []
    for cands, pick in zip(reversed(pruned), reversed(pick_tabs)):
        j = int(pick[b])
        if j < 0:
            return None
        chosen_rev.append(cands[j])
        b -= cands[j].cost
    return list(reversed(chosen_rev))


def _knapsack_2d(cand_tabs: List[List[_Candidate]], budget: float, K: int,
                 plan: Optional["PlannerCache"] = None
                 ) -> Optional[List[_Candidate]]:
    """Exact DP over (switches used, cores used): ``dp[k][b]`` is the best
    prefix value using exactly ``k`` switches within ``b`` cores.  The
    reconfiguration budget K caps changed pipelines per interval.  Each
    tab is dominance-pruned per switch class first, the ``k`` rows swept
    per pipeline are capped at the prefix length, and budget columns
    beyond the prefix's reachable cost are filled flat rather than swept
    — all three provably change nothing, not even tie-breaks.

    ``plan`` resumes the incumbent DP after the longest value-identical
    pipeline prefix (see ``_knapsack_1d``); ``kmax`` uses the absolute
    pipeline index, which the resume loop preserves."""
    n = len(cand_tabs)
    if not np.isfinite(budget):
        return _bounded_switch_unbounded_cores(cand_tabs, K)
    B = int(np.floor(budget + 1e-9))
    tab_keys = [_tab_key(c) for c in cand_tabs] if plan is not None else []
    start, st = _dp_prefix(plan, ("2d", B, K), tab_keys)
    if st is not None and start == n == len(st["tab_keys"]):
        plan.dp_full_hits += 1
        ch = st["chosen"]
        return None if ch is None else list(ch)
    if start:
        pruned = list(st["pruned"][:start])
        pick_tabs = list(st["pick_tabs"][:start])
        dp_list = list(st["dp_list"][:start])
        hi_list = list(st["hi_list"][:start])
        dp, hi = dp_list[-1], hi_list[-1]
    else:
        pruned, pick_tabs, dp_list, hi_list = [], [], [], []
        dp = np.full((K + 1, B + 1), -np.inf)
        dp[0, :] = 0.0
        hi = 0                           # reachable-cost bound so far
    for i in range(start, n):
        cands = _pruned_memo(plan, tab_keys[i] if plan is not None else (),
                             cand_tabs[i], cross_class=False, vec=False)
        pruned.append(cands)
        cur = np.full((K + 1, B + 1), -np.inf)
        pick = np.full((K + 1, B + 1), -1, dtype=np.int64)
        step = max((c.cost for c in cands if c.cost <= B), default=0)
        hi = min(B, hi + step)
        kmax = min(K, i + 1)             # prefix can't switch more often
        for j, c in enumerate(cands):
            if c.cost > B:
                continue
            dk = 1 if c.switch else 0
            for k in range(dk, kmax + 1):
                cand = dp[k - dk, :hi + 1 - c.cost] + c.value
                seg = cur[k, c.cost:hi + 1]
                sel = pick[k, c.cost:hi + 1]
                better = cand > seg
                seg[better] = cand[better]
                sel[better] = j
        if hi < B:                       # flat tail: nothing costs more
            cur[:, hi + 1:] = cur[:, hi:hi + 1]
            pick[:, hi + 1:] = pick[:, hi:hi + 1]
        pick_tabs.append(pick)
        dp_list.append(cur)
        hi_list.append(hi)
        dp = cur
    chosen = _backtrack_2d(pruned, pick_tabs, dp, B)
    if plan is not None:
        plan._dp_state = {
            "gkey": ("2d", B, K), "tab_keys": tab_keys, "pruned": pruned,
            "dp_list": dp_list, "hi_list": hi_list, "pick_tabs": pick_tabs,
            "chosen": None if chosen is None else tuple(chosen)}
    return chosen


def _backtrack_2d(pruned, pick_tabs, dp, B):
    k_best = int(np.argmax(dp[:, B]))
    if not np.isfinite(dp[k_best, B]):
        return None
    k, b = k_best, B
    chosen_rev: List[_Candidate] = []
    for cands, pick in zip(reversed(pruned), reversed(pick_tabs)):
        j = int(pick[k, b])
        if j < 0:
            return None
        chosen_rev.append(cands[j])
        b -= cands[j].cost
        k -= 1 if cands[j].switch else 0
    return list(reversed(chosen_rev))


def _bounded_switch_unbounded_cores(cand_tabs: List[List[_Candidate]],
                                    K: int) -> Optional[List[_Candidate]]:
    """Unbounded cores, capped switches: pipelines are independent except
    for the switch count, so take each pipeline's best stay, then spend the
    K switches on the largest positive switch gains (pipelines with no
    feasible stay must switch and consume budget first)."""
    best_stay = []
    best_switch = []
    for cands in cand_tabs:
        stays = [c for c in cands if not c.switch]
        sws = [c for c in cands if c.switch]
        best_stay.append(max(stays, key=lambda c: c.value) if stays else None)
        best_switch.append(max(sws, key=lambda c: c.value) if sws else None)
    chosen: List[Optional[_Candidate]] = list(best_stay)
    forced = [i for i, s in enumerate(best_stay) if s is None]
    if len(forced) > K:
        return None
    for i in forced:
        if best_switch[i] is None:
            return None
        chosen[i] = best_switch[i]
    left = K - len(forced)
    gains = sorted(
        ((best_switch[i].value - best_stay[i].value, i)
         for i in range(len(cand_tabs))
         if best_stay[i] is not None and best_switch[i] is not None
         and best_switch[i].value > best_stay[i].value),
        reverse=True)
    for gain, i in gains[:left]:
        chosen[i] = best_switch[i]
    return chosen  # type: ignore[return-value]


def _prune_candidates_vec(cands: List[_Candidate],
                          cross_class: bool) -> List[_Candidate]:
    """Vector-cost analogue of ``_prune_candidates``: a candidate dies when
    some other candidate strictly beats its value at no higher cost in
    *every* device class, plus exact ``(cost, value)`` duplicates (first
    kept).  Same strictness discipline — a strict vector dominator wins at
    every budget vector in the monotone N-d DP, so pruning is invisible
    even on ties; with ``cross_class=False`` domination never crosses the
    stay/switch boundary (they draw from different ``k`` rows)."""
    n = len(cands)
    if n <= 1:
        return cands
    costs = np.array([c.cost for c in cands], dtype=np.int64)  # (n, C)
    vals = np.array([c.value for c in cands])
    sw = np.array([c.switch for c in cands], dtype=bool)
    le = (costs[None, :, :] <= costs[:, None, :]).all(axis=-1)  # j <= i
    gt = vals[None, :] > vals[:, None]                          # j beats i
    dom = le & gt
    if not cross_class:
        dom &= sw[None, :] == sw[:, None]
    dominated = dom.any(axis=1)
    seen = set()
    out = []
    for i, c in enumerate(cands):
        if dominated[i]:
            continue
        key = (c.cost, c.value) if cross_class else (c.cost, c.value,
                                                     c.switch)
        if key in seen:
            continue
        seen.add(key)
        out.append(c)
    return out


def _knapsack_nd(cand_tabs: List[List[_Candidate]],
                 budgets: Sequence[float],
                 K: Optional[int] = None,
                 plan: Optional["PlannerCache"] = None
                 ) -> Optional[List[_Candidate]]:
    """Exact multiple-choice knapsack over per-class budget vectors —
    candidate costs are int tuples aligned with the cluster's device
    classes.  Structurally the 1-D DP with the budget axis replaced by a
    budget *grid* (tuple slices shift every class at once), plus the
    optional exactly-``K``-switches leading axis of the 2-D DP.  Each
    class's axis is capped at the prefix's reachable cost (sum of per-tab
    maxima), so tiny accelerator budgets keep the grid tiny regardless of
    how large the CPU pool is.  Same candidate order, float operations and
    strict tie-breaking as the scalar DPs — the brute oracle's
    first-occurrence argmax is reproduced exactly.

    ``plan`` resumes the incumbent DP after the longest value-identical
    pipeline prefix (see ``_knapsack_1d``).  The reach-capped grid ``B``
    is part of the resume key: the reach sums span *all* tabs, so any tab
    change that moves the grid invalidates the whole state, and a matching
    key guarantees identical array shapes."""
    C = len(budgets)
    if all(not np.isfinite(b) for b in budgets):
        if K is None:
            return [max(cands, key=lambda c: c.value) for cands in cand_tabs]
        return _bounded_switch_unbounded_cores(cand_tabs, K)
    reach = [0] * C
    for cands in cand_tabs:
        for c in range(C):
            reach[c] += max((cc.cost[c] for cc in cands), default=0)
    B = tuple(min(int(np.floor(b + 1e-9)), reach[c]) if np.isfinite(b)
              else reach[c]
              for c, b in enumerate(budgets))
    n = len(cand_tabs)
    tab_keys = [_tab_key(c) for c in cand_tabs] if plan is not None else []
    start, st = _dp_prefix(plan, ("nd", B, K), tab_keys)
    if st is not None and start == n == len(st["tab_keys"]):
        plan.dp_full_hits += 1
        ch = st["chosen"]
        return None if ch is None else list(ch)
    shape = tuple(b + 1 for b in B)
    if start:
        pruned = list(st["pruned"][:start])
        pick_tabs = list(st["pick_tabs"][:start])
        dp_list = list(st["dp_list"][:start])
        dp = dp_list[-1]
    else:
        pruned, pick_tabs, dp_list = [], [], []
        if K is None:
            dp = np.zeros(shape)
        else:
            dp = np.full((K + 1,) + shape, -np.inf)
            dp[0] = 0.0
    for i in range(start, n):
        cands = _pruned_memo(plan, tab_keys[i] if plan is not None else (),
                             cand_tabs[i], cross_class=(K is None), vec=True)
        pruned.append(cands)
        cur = np.full(dp.shape, -np.inf)
        pick = np.full(dp.shape, -1, dtype=np.int64)
        kmax = min(K, i + 1) if K is not None else None
        for j, c in enumerate(cands):
            if any(cc > bb for cc, bb in zip(c.cost, B)):
                continue
            src = tuple(slice(0, bb + 1 - cc) for cc, bb in zip(c.cost, B))
            dst = tuple(slice(cc, None) for cc in c.cost)
            if K is None:
                cand = dp[src] + c.value
                seg = cur[dst]
                sel = pick[dst]
                better = cand > seg
                seg[better] = cand[better]
                sel[better] = j
            else:
                dk = 1 if c.switch else 0
                for k in range(dk, kmax + 1):
                    cand = dp[(k - dk,) + src] + c.value
                    seg = cur[(k,) + dst]
                    sel = pick[(k,) + dst]
                    better = cand > seg
                    seg[better] = cand[better]
                    sel[better] = j
        pick_tabs.append(pick)
        dp_list.append(cur)
        dp = cur
    chosen = _backtrack_nd(pruned, pick_tabs, dp, B, K)
    if plan is not None:
        plan._dp_state = {
            "gkey": ("nd", B, K), "tab_keys": tab_keys, "pruned": pruned,
            "dp_list": dp_list, "hi_list": [], "pick_tabs": pick_tabs,
            "chosen": None if chosen is None else tuple(chosen)}
    return chosen


def _backtrack_nd(pruned, pick_tabs, dp, B, K):
    end = tuple(B)
    if K is None:
        if not np.isfinite(dp[end]):
            return None
        state = end
    else:
        k_best = int(np.argmax(dp[(slice(None),) + end]))
        if not np.isfinite(dp[(k_best,) + end]):
            return None
        state = (k_best,) + end
    chosen_rev: List[_Candidate] = []
    for cands, pick in zip(reversed(pruned), reversed(pick_tabs)):
        j = int(pick[state])
        if j < 0:
            return None
        chosen_rev.append(cands[j])
        if K is None:
            state = tuple(s - cc for s, cc in zip(state, cands[j].cost))
        else:
            dk = 1 if cands[j].switch else 0
            state = (state[0] - dk,) + tuple(
                s - cc for s, cc in zip(state[1:], cands[j].cost))
    return list(reversed(chosen_rev))


def solve_cluster_brute(cluster, arrivals: Sequence[float],
                        obj: Objective = Objective(),
                        budget: Optional[float] = None,
                        max_replicas: int = DEFAULT_MAX_REPLICAS,
                        latency_model: str = "worst_case",
                        current=None,
                        switch_cost: float = 0.0,
                        switch_budget: Optional[int] = None,
                        sla_weights: Optional[Sequence[float]] = None,
                        overlap: bool = False,
                        serving=None
                        ) -> ClusterSolution:
    """Oracle: exhaustive cross-product over every pipeline's full feasible
    config set (not just the frontier) — validates the frontier
    construction, the knapsack, and the switch-penalty/SLA-weight/overlap
    accounting on toy clusters.  The incumbent (``current``) is appended to
    a pipeline's table when feasible at the new rate and not already in it
    (held replica counts are generally off the n*-substituted grid).  With
    ``overlap=True`` the budget constraint is evaluated over the transition
    charge ``sum_p max(old_p, new_p)`` (old from ``serving``, default
    ``current``) exactly as ``solve_cluster`` plans.  Heterogeneous
    clusters: the tables carry per-class cost vectors and feasibility is
    checked per class (overlap maxes taken elementwise), matching the
    ``_knapsack_nd`` fast path's constraint exactly."""
    t0 = time.perf_counter()
    hetero = bool(getattr(cluster, "is_hetero", False))
    classes = cluster.device_classes if hetero else None
    if budget is None:
        budgets = cluster.budget_vector if hetero else None
        budget = cluster.cores
    elif hetero:
        if not isinstance(budget, Mapping):
            raise ValueError("heterogeneous cluster needs a per-class "
                             "budget mapping, not a scalar")
        budgets = tuple(float(budget.get(c, 0.0)) for c in classes)
    weights = _resolve_weights(cluster, sla_weights)
    if current is not None and len(current.pipelines) != len(cluster.pipelines):
        raise ValueError("current config/cluster pipeline count mismatch")
    old_costs = _overlap_old_costs(cluster, current, overlap, serving,
                                   classes)
    serving_cfg = serving if (serving is not None and current is not None) \
        else None
    if serving_cfg is not None and \
            len(serving_cfg.pipelines) != len(cluster.pipelines):
        raise ValueError("serving config/cluster pipeline count mismatch")
    tables = []
    for p_i, (pipe, lam) in enumerate(zip(cluster.pipelines, arrivals)):
        opts, picks, cost, score, pas_v, lat = _combo_eval(
            pipe, lam, obj, max_replicas, latency_model)
        if len(cost) == 0:
            return _cluster_infeasible(cluster, t0, "cluster_brute")
        if hetero:
            cvec = _combo_cost_by_class(opts, picks, classes).T
            tab = [FrontierPoint(float(cost[i]), float(score[i]),
                                 float(pas_v[i]), float(lat[i]),
                                 _point_config(opts, picks, i),
                                 cost_vec=tuple(float(x) for x in cvec[i]))
                   for i in range(len(cost))]
        else:
            tab = [FrontierPoint(float(cost[i]), float(score[i]),
                                 float(pas_v[i]), float(lat[i]),
                                 _point_config(opts, picks, i))
                   for i in range(len(cost))]
        if current is not None:
            inc = evaluate_config(pipe, current.pipelines[p_i], lam, obj,
                                  latency_model, classes)
            if inc is not None and all(p.config != inc.config for p in tab):
                tab.append(inc)
        if serving_cfg is not None and \
                serving_cfg.pipelines[p_i] != current.pipelines[p_i]:
            rev = evaluate_config(pipe, serving_cfg.pipelines[p_i], lam,
                                  obj, latency_model, classes)
            if rev is not None and all(p.config != rev.config for p in tab):
                tab.append(rev)
        tables.append(tab)
    best_v, best = -np.inf, None
    for combo in itertools.product(*tables):
        if hetero:
            if old_costs is not None:
                tot_vec = [sum(max(p.cost_vec[c], o[c]) for p, o
                               in zip(combo, old_costs))
                           for c in range(len(classes))]
            else:
                tot_vec = [sum(p.cost_vec[c] for p in combo)
                           for c in range(len(classes))]
            if any(t > b + 1e-9 for t, b in zip(tot_vec, budgets)):
                continue
        else:
            if old_costs is not None:
                tot_c = sum(max(p.cost, o) for p, o in zip(combo, old_costs))
            else:
                tot_c = sum(p.cost for p in combo)
            if tot_c > budget + 1e-9:
                continue
        n_sw = _charged_switches(combo, current, serving_cfg)
        if switch_budget is not None and n_sw > switch_budget:
            continue
        v = sum(w * p.objective for w, p in zip(weights, combo)) \
            - switch_cost * n_sw
        if v > best_v:
            best_v, best = v, combo
    if best is None:
        return _cluster_infeasible(cluster, t0, "cluster_brute")
    return _cluster_solution(cluster, list(best), t0, "cluster_brute",
                             weights, current, switch_cost, serving_cfg)
