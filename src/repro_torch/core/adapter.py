"""Online adapter (paper §3): monitor -> predict -> optimize -> reconfigure.

``run_trace`` drives a policy over a per-second rate trace through the
discrete-event simulator at a fixed adaptation interval (paper: 8 s
adaptation + <2 s decision = 10 s monitoring interval), recording
per-interval PAS / cost and global latency / drop / SLA metrics.

``run_cluster_trace`` is the cluster-level analogue: N per-pipeline rate
traces drive one ``ClusterSimulator`` (one event heap, one shared core
pool); at each boundary a cluster policy (joint knapsack, or proportional
static split) proposes a joint configuration, infeasible pipelines hold
the config the simulator is committed to, and the joint config is
admitted only if it fits the core budget through its §5.3 transition
windows — otherwise the admissible subset is applied staged (downsizes
now, grows once the freed cores leave their windows).

Cluster demand estimation mirrors what the single-pipeline ``run_trace``
already supports: reactive (max of the trailing window), burst-aware
(max over a longer window, so a spike that peaked a minute ago still
reserves capacity — what the static-split baselines get), per-pipeline
``LSTMPredictor``, or ``OraclePredictor`` ground truth.  The joint policy
can additionally be made switch-cost-aware (``switch_cost`` /
``switch_budget`` / ``adaptation_delay`` — paper §5.3's ~8 s adaptation
overhead), in which case each interval's recorded PAS is the *realized*
time-weighted value: a reconfigured pipeline serves the old config for
the adaptation window before the new one takes effect.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import baselines as BL
from repro_torch.core import optimizer as OPT
from repro_torch.core.accuracy import pas_of
from repro_torch.core.cluster import ClusterConfig, ClusterModel
from repro_torch.core.pipeline import PipelineConfig, PipelineModel
from repro_torch.core.simulator import (ClusterSimulator, PipelineSimulator,
                                  RoundPipelineSimulator,
                                  StructPipelineSimulator, EVENT_CORES,
                                  make_cluster_simulator)
from repro_torch.core.trace import SeedLike, arrivals_from_rates
from repro_torch.serving.request import Request, RequestPool

ADAPT_INTERVAL = 10.0       # paper §5.3: 8 s adaptation + 2 s decision


@dataclasses.dataclass
class IntervalRecord:
    t: float
    lam_true: float
    lam_hat: float
    pas: float
    cost: float
    feasible: bool
    solve_time: float


@dataclasses.dataclass
class TraceResult:
    policy: str
    intervals: List[IntervalRecord]
    latencies: np.ndarray
    arrived: int
    completed: int
    dropped: int
    sla: float
    # simulator observability (filled by run_trace; defaults keep older
    # constructors working)
    sim_events: int = 0
    peak_queue_depth: int = 0
    # total wall seconds spent inside the policy's solver over the run
    # (bootstrap decision included) — the benches' per-phase breakdown
    # (solver_wall_s vs sim_wall_s) reads this directly instead of
    # re-instrumenting externally
    solver_wall_s: float = 0.0

    @property
    def sla_violation_rate(self) -> float:
        if self.arrived == 0:
            return 0.0
        late = int(np.sum(self.latencies > self.sla))
        return (late + self.dropped) / self.arrived

    @property
    def mean_pas(self) -> float:
        return float(np.mean([r.pas for r in self.intervals]))

    @property
    def mean_cost(self) -> float:
        return float(np.mean([r.cost for r in self.intervals]))

    def summary(self) -> Dict[str, float]:
        return {
            "policy": self.policy,
            "mean_pas": round(self.mean_pas, 3),
            "mean_cost": round(self.mean_cost, 2),
            "sla_violation_rate": round(self.sla_violation_rate, 4),
            "dropped": self.dropped,
            "completed": self.completed,
            "p99_latency": round(float(np.percentile(self.latencies, 99)), 3)
            if len(self.latencies) else float("nan"),
        }


def run_trace(pipe: PipelineModel, rates: np.ndarray, policy: str = "ipa",
              obj: Optional[OPT.Objective] = None,
              predictor=None, oracle=None,
              interval: float = ADAPT_INTERVAL, seed: int = 0,
              max_replicas: int = OPT.DEFAULT_MAX_REPLICAS,
              solver: Optional[str] = None,
              event_core: str = "heap") -> TraceResult:
    """policy in {ipa, fa2_low, fa2_high, rim}; predictor: LSTMPredictor or
    None (reactive); oracle: OraclePredictor for the Fig.-16 'baseline'.
    ``solver`` overrides the policy's enumeration solver (``vec`` — the
    default hot path — ``brute`` or ``enum``); the vec-vs-brute pinning
    tests replay identical traces through both.  ``event_core`` selects
    the simulator hot loop (``"heap"`` reference, ``"struct"`` — the
    structured-array core — or ``"round"``, the columnar service-round
    engine; all event-for-event identical)."""
    rates = np.asarray(rates, np.float64)
    times = arrivals_from_rates(rates, seed=seed)

    # initial config from the first-second load
    lam0 = float(rates[:int(interval)].max())
    solver_wall = 0.0
    sol = _decide(pipe, lam0, policy, obj, max_replicas, solver)
    solver_wall += sol.solve_time
    if not sol.feasible:
        # bootstrap fallback: cheapest feasible config (production behaviour:
        # a policy must never leave the pipeline unconfigured); it honours
        # the same solver override so pinned replays stay single-solver
        sol = BL.fa2(pipe, lam0, "low", max_replicas=max_replicas,
                     **({"solver": solver} if solver is not None else {}))
        solver_wall += sol.solve_time
    if not sol.feasible:
        raise RuntimeError(f"no feasible initial config for {policy}")
    if event_core not in EVENT_CORES:
        raise ValueError(f"unknown event core {event_core!r}; "
                         f"choose from {EVENT_CORES}")
    # requests never outlive their completion event here, so the simulator
    # can recycle them through a pool instead of churning the allocator
    # (the struct core carries no request objects and ignores the pool)
    pool = RequestPool()
    sim_cls = {"heap": PipelineSimulator,
               "struct": StructPipelineSimulator,
               "round": RoundPipelineSimulator}[event_core]
    sim = sim_cls(pipe, sol.config, request_pool=pool)
    sim.lam_est = lam0
    records: List[IntervalRecord] = []

    horizon = len(rates)
    n_intervals = int(np.ceil(horizon / interval))
    ti = 0
    for k in range(n_intervals):
        t0, t1 = k * interval, min((k + 1) * interval, horizon)
        # --- monitor + predict (at the boundary, using only the past) ----
        hist = rates[:int(t0)]
        if oracle is not None:
            lam_hat = oracle.predict_at(int(t0))
        elif predictor is not None and len(hist) >= 1:
            lam_hat = predictor.predict(hist)
        else:
            lam_hat = float(hist[-20:].max()) if len(hist) else lam0
        # --- optimize + reconfigure --------------------------------------
        sol = _decide(pipe, lam_hat, policy, obj, max_replicas, solver)
        solver_wall += sol.solve_time
        if sol.feasible:
            sim.reconfigure(sol.config)
            sim.lam_est = lam_hat
            cfg = sol.config
        else:  # hold the config the simulator is actually running
            cfg = sim.current_config
        records.append(IntervalRecord(
            t=t0, lam_true=float(rates[int(t0):int(t1)].max()),
            lam_hat=float(lam_hat), pas=pas_of(cfg, pipe),
            cost=cfg.cost(pipe), feasible=sol.feasible,
            solve_time=sol.solve_time))
        # --- serve this interval -----------------------------------------
        # pre-sized arrival batching: one sorted-array cut + bulk inject
        # per window (the simulator acquires the requests from the pool)
        i1 = int(np.searchsorted(times, t1, side="left"))
        sim.inject_arrivals(times[ti:i1])
        ti = i1
        sim.run_until(t1)
    # flush stragglers
    sim.run_until(horizon + 4 * pipe.sla)
    m = sim.metrics
    return TraceResult(policy=policy, intervals=records,
                       latencies=np.array(m.latencies, dtype=np.float64),
                       arrived=m.arrived, completed=m.completed,
                       dropped=m.dropped, sla=pipe.sla,
                       sim_events=sim.events_processed,
                       peak_queue_depth=sim.peak_queue_depth,
                       solver_wall_s=float(solver_wall))


def _decide(pipe, lam, policy, obj, max_replicas, solver=None):
    try:
        fn = BL.POLICIES[policy]
    except KeyError:
        raise ValueError(policy) from None
    kw = {"max_replicas": max_replicas}
    if policy == "ipa":
        kw["obj"] = obj
    if solver is not None:
        kw["solver"] = solver
    return fn(pipe, lam, **kw)


# ---------------------------------------------------------------------------
# cluster level
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ClusterTraceResult:
    """One cluster policy over N per-pipeline traces in one shared pool."""
    policy: str
    budget: float
    per_pipeline: List[TraceResult]
    sim_events: int = 0
    peak_queue_depth: int = 0
    # committed pipeline-level reconfiguration decisions over the run (the
    # simulator's log: (decided_at, pipeline, scheduled_apply_at) tuples; a
    # decision superseded within its adaptation window keeps its entry but
    # its scheduled apply never fires)
    n_reconfigs: int = 0
    reconfig_log: List = dataclasses.field(default_factory=list)
    # supremum over the run of the cores the *serving* replica fleets held
    # at any instant (transition windows included) — the witness for the
    # overlap invariant peak_serving_cores <= budget
    peak_serving_cores: float = 0.0
    # total wall seconds inside the joint solver over the run (bootstrap
    # included; each interval's joint solve counted once, not per
    # pipeline) — the bench breakdown's solver_wall_s
    solver_wall_s: float = 0.0
    # FrontierCache.stats of the run's cache (None when caching was
    # bypassed) — hit-rate observability for the benches
    frontier_cache_stats: Optional[Dict] = None

    @property
    def mean_pas(self) -> float:
        """Mean over pipelines of per-pipeline interval-mean PAS."""
        return float(np.mean([r.mean_pas for r in self.per_pipeline]))

    @property
    def mean_cost(self) -> float:
        """Interval-mean of the summed (cluster-wide) core allocation."""
        return float(sum(r.mean_cost for r in self.per_pipeline))

    def mean_objective(self, obj: OPT.Objective) -> float:
        """Interval-mean summed alpha*PAS - beta*cost (the arbitration
        objective, minus the negligible delta batch penalty that the
        interval records do not carry)."""
        return float(sum(obj.alpha * r.mean_pas - obj.beta * r.mean_cost
                         for r in self.per_pipeline))

    @property
    def dropped(self) -> int:
        return sum(r.dropped for r in self.per_pipeline)

    @property
    def completed(self) -> int:
        return sum(r.completed for r in self.per_pipeline)

    @property
    def arrived(self) -> int:
        return sum(r.arrived for r in self.per_pipeline)

    def summary(self) -> Dict[str, object]:
        return {
            "policy": self.policy,
            "budget": self.budget,
            "mean_pas": round(self.mean_pas, 3),
            "mean_cost": round(self.mean_cost, 2),
            "dropped": self.dropped,
            "completed": self.completed,
            "per_pipeline": [r.summary() for r in self.per_pipeline],
        }


def reactive_demand(trace: np.ndarray, t0: float,
                    interval: float = ADAPT_INTERVAL,
                    window: int = 20) -> float:
    """Reactive (no-predictor) demand estimate at boundary ``t0``: max of
    the last ``window`` s of past rates, bootstrapping from the first
    interval, and 0 once the trace has ended (a finished pipeline must
    stop competing for shared cores).  Shared with the cluster bench's
    pointwise dominance gate so both always probe the same demand points.
    """
    i = int(t0)
    if i >= len(trace):
        return 0.0
    if i == 0:
        return float(trace[:int(interval)].max())
    return float(trace[max(i - window, 0):i].max())


def burst_demand(trace: np.ndarray, t0: float,
                 interval: float = ADAPT_INTERVAL,
                 window: int = 60) -> float:
    """Burst-aware max-of-window estimate: like ``reactive_demand`` but
    over a longer trailing window (default 60 s), so a burst that peaked
    tens of seconds ago still reserves capacity through its decay instead
    of the estimate collapsing the moment the 20 s window slides past the
    peak — the cheap anti-thrash guard the static-split baselines get."""
    return reactive_demand(trace, t0, interval, window=window)


DEMAND_ESTIMATORS = {"reactive": reactive_demand, "burst": burst_demand}


def _cluster_demands(rates, t0: float, interval: float, demand_mode: str,
                     predictors, oracles) -> List[float]:
    """Per-pipeline demand estimates at boundary ``t0``: oracle beats
    predictor beats the windowed fallback, per pipeline.  A pipeline whose
    trace has ended always estimates 0 (it must release the shared pool,
    whatever its predictor says about the stale history)."""
    try:
        fallback = DEMAND_ESTIMATORS[demand_mode]
    except KeyError:
        raise ValueError(f"demand_mode {demand_mode!r}") from None
    i = int(t0)
    out = []
    for p, r in enumerate(rates):
        if i >= len(r):
            out.append(0.0)
            continue
        if oracles is not None and oracles[p] is not None:
            out.append(float(oracles[p].predict_at(i)))
        elif predictors is not None and predictors[p] is not None and i >= 1:
            out.append(float(predictors[p].predict(r[:i])))
        else:
            out.append(fallback(r, t0, interval))
    return out


def _staged_admission(cluster, mixed: ClusterConfig,
                      committed: Sequence[PipelineConfig],
                      serving: Sequence[PipelineConfig]):
    """Admit the subset of a joint proposal that fits the budget *through*
    its transition windows, holding the rest for a later boundary.

    Used when ``mixed`` fits C after its windows but not through them
    (``sum_p max(old_p, new_p) > C``).  Changes are admitted greedily by
    ascending transition-charge delta — downsizes first (their charge is
    the old cost they already hold, so they are always admissible), then
    the cheapest grows — which is exactly the §5.3 staging a real shared
    pool needs: free the cores this interval, grant them the next.  This
    keeps policies that do not plan overlap-aware (the static splits)
    live on opposite-direction resizes: without it a shrink+grow pair
    whose combined transition never fits would be held forever.  Returns
    ``(staged config, per-pipeline admitted flags)``.
    """
    serve_c = [s.cost(pipe) for s, pipe in zip(serving, cluster.pipelines)]
    hold_c = [max(sc, c.cost(pipe))
              for sc, c, pipe in zip(serve_c, committed, cluster.pipelines)]
    total = sum(hold_c)
    chosen = list(committed)
    flags = [False] * cluster.n_pipelines
    if getattr(cluster, "is_hetero", False):
        # per-class ledgers: the same greedy order (ascending total-charge
        # delta), but a change is admitted only when *every* class fits
        classes = cluster.device_classes
        serve_v = [np.asarray(s.cost_by_class(pipe, classes))
                   for s, pipe in zip(serving, cluster.pipelines)]
        hold_v = [np.maximum(sv, np.asarray(c.cost_by_class(pipe, classes)))
                  for sv, c, pipe in zip(serve_v, committed,
                                         cluster.pipelines)]
        total_v = np.sum(hold_v, axis=0)
        budget_v = np.asarray(cluster.budget_vector)
        deltas = sorted(
            (float(np.sum(np.maximum(
                serve_v[p],
                np.asarray(mixed.pipelines[p].cost_by_class(pipe, classes)))
                - hold_v[p])), p)
            for p, pipe in enumerate(cluster.pipelines)
            if mixed.pipelines[p] != committed[p])
        for _, p in deltas:
            pipe = cluster.pipelines[p]
            new_hold = np.maximum(
                serve_v[p],
                np.asarray(mixed.pipelines[p].cost_by_class(pipe, classes)))
            cand = total_v + (new_hold - hold_v[p])
            if bool(np.all(cand <= budget_v + 1e-9)):
                chosen[p] = mixed.pipelines[p]
                flags[p] = True
                total_v = cand
                hold_v[p] = new_hold
        return ClusterConfig(tuple(chosen)), flags
    deltas = sorted(
        (max(serve_c[p], mixed.pipelines[p].cost(pipe)) - hold_c[p], p)
        for p, pipe in enumerate(cluster.pipelines)
        if mixed.pipelines[p] != committed[p])
    for d, p in deltas:
        if total + d <= cluster.cores + 1e-9:
            chosen[p] = mixed.pipelines[p]
            flags[p] = True
            total += d
    return ClusterConfig(tuple(chosen)), flags


def _pipeline_seeds(seed: SeedLike, n: int) -> List:
    """Per-pipeline arrival-stream seeds for ``run_cluster_trace``.

    A ``np.random.SeedSequence`` derives one child per pipeline —
    collision-free by construction, the hygiene the sweep harness relies
    on when thousands of cells each need N independent streams.  The
    children are built statelessly (entropy + extended spawn_key, exactly
    what ``spawn`` would produce on a fresh sequence) rather than via
    ``seed.spawn(n)``, whose internal counter would make a second run
    with the *same object* silently use different streams.  A plain int
    keeps the legacy ``seed + 1000003 * i`` arithmetic bit-for-bit (the
    golden cluster traces are pinned to those exact streams).
    """
    if isinstance(seed, np.random.SeedSequence):
        return [np.random.SeedSequence(
            entropy=seed.entropy,
            spawn_key=tuple(seed.spawn_key) + (i,)) for i in range(n)]
    return [seed + 1000003 * i for i in range(n)]


def _decide_cluster(cluster, lams, policy, obj, max_replicas,
                    ipa_kwargs=None, cache=None):
    try:
        fn = BL.CLUSTER_POLICIES[policy]
    except KeyError:
        raise ValueError(policy) from None
    kw = {"obj": obj, "max_replicas": max_replicas, "cache": cache}
    if policy == "ipa" and ipa_kwargs:
        kw.update(ipa_kwargs)
    return fn(cluster, lams, **kw)


def run_cluster_trace(cluster: ClusterModel,
                      rates: Sequence[np.ndarray],
                      policy: str = "ipa",
                      obj: Optional[OPT.Objective] = None,
                      interval: float = ADAPT_INTERVAL, seed: SeedLike = 0,
                      max_replicas: int = OPT.DEFAULT_MAX_REPLICAS,
                      predictors: Optional[Sequence] = None,
                      oracles: Optional[Sequence] = None,
                      demand_mode: str = "reactive",
                      switch_cost: float = 0.0,
                      switch_budget: Optional[int] = None,
                      adaptation_delay: float = 0.0,
                      sla_weights: Optional[Sequence[float]] = None,
                      frontier_cache="auto",
                      event_core: str = "heap"
                      ) -> ClusterTraceResult:
    """Drive N per-pipeline rate traces through one ``ClusterSimulator``.

    ``policy`` is a key of ``baselines.CLUSTER_POLICIES``: ``ipa`` (joint
    knapsack arbitration) or ``split_{ipa,fa2_low,fa2_high,rim}``
    (proportional static split).  At each adaptation boundary the policy
    proposes per-pipeline configs from the demand estimates; a pipeline
    whose sub-solution is infeasible holds the config the simulator is
    *committed* to (``pipeline_config`` — the in-flight transition target
    while one is rolling out, never the stale pre-transition config), and
    the mixed joint config is applied only if it fits the shared core
    budget — otherwise every pipeline holds.

    Demand estimation (per pipeline, past-only): ``oracles[p]`` (ground-
    truth future max, Fig. 16's baseline) beats ``predictors[p]`` (e.g. a
    trained ``LSTMPredictor``) beats the ``demand_mode`` fallback
    (``"reactive"``: trailing 20 s max; ``"burst"``: trailing 60 s max).

    Switch-cost knobs (joint policy only): ``switch_cost`` (objective
    units per changed pipeline — §5.3's adaptation overhead as lost
    objective, giving the solver hysteresis), ``switch_budget`` (max
    pipelines changed per interval) and ``sla_weights`` flow into
    ``optimizer.solve_cluster`` together with the simulator's committed
    config as the incumbent.  ``adaptation_delay > 0`` makes the simulator
    serve the old config for that window after each change; interval PAS
    *and cost* records become realized time-weighted values, the joint
    solver plans overlap-aware (``overlap=True`` with the serving configs,
    so each changed pipeline is budgeted at ``max(old, new)`` through its
    window), and a joint proposal is admitted only if it fits the budget
    throughout its transition (``ClusterSimulator.fits_transition``) —
    otherwise it is admitted *staged* via ``_staged_admission``:
    downsizes immediately (their transition charge is what they already
    hold), grows at a later boundary once the freed cores leave their
    windows.

    ``frontier_cache``: the cross-interval ``optimizer.FrontierCache``
    threaded through every boundary's policy call.  ``"auto"`` (default)
    creates a fresh exact-keyed cache for this run — arrival estimates
    repeat heavily across intervals, so most frontier builds become dict
    hits while staying bit-identical to uncached planning (property-
    tested).  ``None`` bypasses caching (the A/B knob); passing a
    ``FrontierCache`` instance shares it across runs of the *same* model
    objects.

    ``event_core``: the simulator hot loop — ``"heap"`` (reference),
    ``"struct"`` (structured-array batch-pop core) or ``"round"``
    (service-round core: per-pipeline event frontiers retired in
    independent rounds), all event-for-event identical; BENCH_scale
    replays and gates all three.
    """
    rates = [np.asarray(r, np.float64) for r in rates]
    if len(rates) != cluster.n_pipelines:
        raise ValueError("one rate trace per pipeline required")
    for name, seq in (("predictors", predictors), ("oracles", oracles)):
        if seq is not None and len(seq) != cluster.n_pipelines:
            raise ValueError(f"one {name} entry per pipeline required")
    if policy != "ipa" and (switch_cost != 0.0 or switch_budget is not None
                            or sla_weights is not None):
        # silently ignoring these would make a "split with hysteresis/
        # weights" benchmark measure the wrong experiment; weight split
        # baselines via ClusterModel.sla_weights instead
        raise ValueError("switch_cost/switch_budget/sla_weights apply to "
                         "the joint 'ipa' policy only")
    horizon = max(len(r) for r in rates)
    times = [arrivals_from_rates(r, seed=s)
             for r, s in zip(rates, _pipeline_seeds(seed, len(rates)))]
    ipa_kwargs = {"switch_cost": switch_cost, "switch_budget": switch_budget,
                  "sla_weights": sla_weights,
                  # §5.3 windows in play: plan against max(old, new) so a
                  # downsizer's freed cores are never granted mid-window
                  "overlap": adaptation_delay > 0}
    if frontier_cache == "auto":
        # the planner cache layers whole-solve / DP-prefix / eval memos on
        # top of the frontier memo, all exact-keyed: bit-identical results
        cache = OPT.PlannerCache()
    else:
        cache = frontier_cache          # an instance, or None = bypass

    # bootstrap from the first-interval peaks; fall back to cheapest
    # feasible (joint fa2-low split would still have to fit C, so use the
    # joint solver with a pure-cost objective)
    lam0 = [float(r[:int(interval)].max()) for r in rates]
    solver_wall = 0.0
    sol = _decide_cluster(cluster, lam0, policy, obj, max_replicas,
                          ipa_kwargs, cache)
    solver_wall += sol.solve_time
    if not sol.feasible:
        sol = OPT.solve_cluster(
            cluster, lam0, OPT.Objective(alpha=0.0, beta=1.0, delta=1e-6),
            max_replicas=max_replicas, cache=cache)
        solver_wall += sol.solve_time
    if not sol.feasible:
        raise RuntimeError(
            f"no feasible initial cluster config for {policy} "
            f"within budget {cluster.cores}")
    pool = RequestPool()
    sim = make_cluster_simulator(cluster, sol.config, event_core=event_core,
                                 request_pool=pool,
                                 adaptation_delay=adaptation_delay)
    for p, lam in enumerate(lam0):
        sim.set_lam_est(p, lam)

    records: List[List[IntervalRecord]] = [[] for _ in rates]
    ti = [0] * len(rates)
    # when the committed config of pipeline p changes at a boundary, its
    # stages keep serving the old config until this absolute time — the
    # realized-PAS blend below charges the transition window to it
    pending_until = [0.0] * len(rates)
    n_intervals = int(np.ceil(horizon / interval))
    for k in range(n_intervals):
        t0, t1 = k * interval, min((k + 1) * interval, horizon)
        # --- monitor + predict (at the boundary, using only the past) ----
        lam_hat = _cluster_demands(rates, t0, interval, demand_mode,
                                   predictors, oracles)
        # --- optimize + arbitrate + reconfigure --------------------------
        committed_before = [sim.pipeline_config(p)
                            for p in range(cluster.n_pipelines)]
        serving_before = [sim.serving_config(p)
                          for p in range(cluster.n_pipelines)]
        if policy == "ipa":
            ipa_kwargs["current"] = sim.current_config
            # mid-window the serving fleet differs from the committed
            # incumbent; the overlap charge must price what actually holds
            # cores right now
            ipa_kwargs["serving"] = ClusterConfig(tuple(serving_before))
        sol = _decide_cluster(cluster, lam_hat, policy, obj, max_replicas,
                              ipa_kwargs, cache)
        solver_wall += sol.solve_time
        per = sol.per_pipeline if sol.per_pipeline else [
            OPT._infeasible(0.0, sol.solver)] * cluster.n_pipelines
        mixed = ClusterConfig(tuple(
            s.config if s.feasible else committed_before[p]
            for p, s in enumerate(per)))
        # admission is transition-aware: the joint proposal must fit C
        # through every adaptation window (max(old, new) per changed
        # pipeline), not merely after them.  A proposal that only fits
        # after its windows is admitted *staged*: downsizes now (their
        # charge is already held), grows once the freed cores leave their
        # windows at a later boundary.  At zero delay there are no
        # windows and an over-budget proposal holds everyone (the PR 2/3
        # behaviour).
        if sim.fits_transition(mixed):
            admitted = [True] * cluster.n_pipelines
            applied = mixed
        elif adaptation_delay > 0:
            applied, admitted = _staged_admission(
                cluster, mixed, committed_before, serving_before)
        else:  # joint overflow, no windows to stage across: everyone holds
            admitted = [False] * cluster.n_pipelines
            applied = sim.current_config
        if any(admitted):
            sim.reconfigure(applied)
            for p, (s, lh) in enumerate(zip(per, lam_hat)):
                if admitted[p] and s.feasible:
                    sim.set_lam_est(p, lh)
        for p, pipe in enumerate(cluster.pipelines):
            cfg = applied.pipelines[p]
            if cfg != committed_before[p]:
                pending_until[p] = t0 + adaptation_delay
            # realized PAS and cost: the fraction of this interval still
            # served at the old config while the §5.3 adaptation window
            # runs out.  Both are blended time-weighted the same way; the
            # sum<=C budget invariant survives the blend because the
            # transition-charged ledger keeps instantaneous serving cost
            # <= C at every instant, so its per-interval time average
            # summed over pipelines is <= C too
            frac = 0.0
            if t1 > t0 and pending_until[p] > t0:
                frac = min(pending_until[p] - t0, t1 - t0) / (t1 - t0)
            pas = frac * pas_of(serving_before[p], pipe) \
                + (1.0 - frac) * pas_of(cfg, pipe)
            cost = frac * serving_before[p].cost(pipe) \
                + (1.0 - frac) * cfg.cost(pipe)
            seg = rates[p][int(t0):int(t1)]   # empty once a shorter
            records[p].append(IntervalRecord(  # pipeline's trace has ended
                t=t0, lam_true=float(seg.max()) if len(seg) else 0.0,
                lam_hat=lam_hat[p], pas=pas,
                # feasible means "this interval's proposal was applied for
                # this pipeline" — under staged admission only the admitted
                # subset counts; a zero-delay overflow holds everyone
                cost=cost,
                feasible=per[p].feasible and admitted[p],
                solve_time=sol.solve_time))
        # --- serve this interval -----------------------------------------
        # pre-sized arrival batching: one sorted-array cut + bulk inject
        # per pipeline per window (the simulator acquires from the pool)
        for p, tt in enumerate(times):
            i1 = int(np.searchsorted(tt, t1, side="left"))
            sim.inject_arrivals(tt[ti[p]:i1], p)
            ti[p] = i1
        sim.run_until(t1)
    # flush stragglers
    sim.run_until(horizon + 4 * max(sim.sla_of))
    results = []
    for p, pipe in enumerate(cluster.pipelines):
        m = sim.metrics_by_pipe[p]
        results.append(TraceResult(
            policy=policy, intervals=records[p],
            latencies=np.array(m.latencies, dtype=np.float64),
            arrived=m.arrived, completed=m.completed, dropped=m.dropped,
            sla=pipe.sla))
    return ClusterTraceResult(policy=policy, budget=float(cluster.cores),
                              per_pipeline=results,
                              sim_events=sim.events_processed,
                              peak_queue_depth=sim.peak_queue_depth,
                              n_reconfigs=sim.n_reconfigs,
                              reconfig_log=list(sim.reconfig_log),
                              peak_serving_cores=sim.peak_serving_cores,
                              solver_wall_s=float(solver_wall),
                              frontier_cache_stats=(
                                  cache.stats if cache is not None
                                  else None))


def run_cell(cluster: ClusterModel, rates: Sequence[np.ndarray],
             policy: str = "ipa",
             obj: Optional[OPT.Objective] = None,
             seed: SeedLike = 0,
             interval: float = ADAPT_INTERVAL,
             max_replicas: int = OPT.DEFAULT_MAX_REPLICAS,
             switch_cost: float = 0.0,
             switch_budget: Optional[int] = None,
             adaptation_delay: float = 0.0,
             demand_mode: str = "reactive",
             frontier_cache="auto",
             event_core: str = "heap") -> Dict:
    """One sweep cell: a full policy-trace run compacted to a JSON-ready
    record (the unit of work ``benchmarks/sweep.py`` fans out across
    worker processes).

    Wraps ``run_cluster_trace`` and flattens its result to plain python
    scalars/lists — no numpy arrays, no config objects — so the record
    pickles cheaply across the process boundary and serializes straight
    into a result shard.  Besides the headline metrics it carries the
    per-phase wall breakdown (``solver_wall_s`` from the trace result vs
    ``sim_wall_s`` = remaining wall) and the ``FrontierCache`` hit/miss
    stats — the *delta* attributable to this cell when the caller passes
    a warm per-worker cache instance — so straggler cells and cache-cold
    policies are diagnosable from the sweep JSON alone.

    Every field except the ``*wall_s`` timings (and the cache stats,
    which depend on what a warm cache saw before this cell) is a pure
    function of the inputs; the sweep's nproc-invariance hash is taken
    over exactly that deterministic remainder.
    """
    o = obj or OPT.Objective()
    cache = frontier_cache
    snap = cache.stats_snapshot() \
        if isinstance(cache, OPT.FrontierCache) else None
    t0 = time.perf_counter()
    res = run_cluster_trace(cluster, rates, policy=policy, obj=o, seed=seed,
                            interval=interval, max_replicas=max_replicas,
                            switch_cost=switch_cost,
                            switch_budget=switch_budget,
                            adaptation_delay=adaptation_delay,
                            demand_mode=demand_mode,
                            frontier_cache=cache, event_core=event_core)
    wall = time.perf_counter() - t0
    horizon = max(len(r) for r in rates)
    lat = np.concatenate([r.latencies for r in res.per_pipeline]) \
        if any(len(r.latencies) for r in res.per_pipeline) \
        else np.empty(0)
    late = sum(int(np.sum(r.latencies > r.sla)) for r in res.per_pipeline)
    arrived = res.arrived
    return {
        "policy": policy,
        "budget": float(cluster.cores),
        "horizon_s": int(horizon),
        "mean_pas": round(res.mean_pas, 6),
        "mean_cost": round(res.mean_cost, 6),
        "mean_objective": round(res.mean_objective(o), 6),
        "arrived": arrived,
        "completed": res.completed,
        "dropped": res.dropped,
        "sla_violation_rate": round((late + res.dropped) / arrived, 6)
        if arrived else 0.0,
        "p50_latency": round(float(np.percentile(lat, 50)), 6)
        if len(lat) else None,
        "p99_latency": round(float(np.percentile(lat, 99)), 6)
        if len(lat) else None,
        "n_reconfigs": res.n_reconfigs,
        "reconfigs_per_hour": round(res.n_reconfigs * 3600.0 / horizon, 3)
        if horizon else 0.0,
        "peak_serving_cores": round(res.peak_serving_cores, 6),
        "sim_events": res.sim_events,
        "peak_queue_depth": res.peak_queue_depth,
        "per_pipeline": [
            {"pipeline": pipe.name,
             "mean_pas": round(r.mean_pas, 6),
             "mean_cost": round(r.mean_cost, 6),
             "completed": r.completed, "dropped": r.dropped}
            for pipe, r in zip(cluster.pipelines, res.per_pipeline)],
        # wall-clock + warm-cache diagnostics: excluded from the sweep's
        # determinism hash (see study.strip_volatile)
        "wall_s": round(wall, 4),
        "solver_wall_s": round(res.solver_wall_s, 4),
        "sim_wall_s": round(wall - res.solver_wall_s, 4),
        "frontier_cache": (cache.stats_since(snap) if snap is not None
                           else res.frontier_cache_stats),
    }
