"""Event-driven simulator of multi-stage inference pipelines (paper §3:
"a discrete event simulator uses these profiling data to estimate the
end-to-end latency and throughput of the pipeline based on the number of
replicas, model variants, and batch sizes at each stage").

The core is cluster-general: ``ClusterSimulator`` runs the stages of N
pipelines (a ``ClusterModel`` sharing one core budget C) in **one event
heap**, with per-pipeline metrics and a shared-pool replica ledger — a
reconfigure that grows one pipeline must fit inside C minus the other
pipelines' current allocations, else ``CoreBudgetExceeded``.
``PipelineSimulator`` is the N=1 special case and keeps the original
single-pipeline API (``metrics``, ``lam_est``, ``reconfigure(PipelineConfig)``).

Per stage: one central queue (batch formation) feeding ``n_s`` replicas
round-robin; service time of a batch of size k under variant m is the
profiled quadratic l_m(k).  Implements the §4.5 dropping policy: requests
whose age exceeds drop_factor x SLA_P are dropped at batch formation.
Reconfiguration (variant/batch/replicas) takes effect immediately at the
adaptation boundary; in-flight batches finish under the old service time.

The core is purely event-driven — there is no periodic "tick".  A
partially filled batch arms exactly one ``timeout`` event at
``head_enter + wait_bound`` (Eq. 7 via ``core.queueing.wait_bound``); the
event carries a per-stage generation counter so that when the batch
dispatches early (filled up, or flushed by an upstream completion) the
stale timeout is ignored on pop instead of being searched for and removed
from the heap.  A dispatch blocked on busy/cold-starting replicas arms a
``wake`` event at the soonest replica-free time.  Per-dispatch drop scans,
latency accumulation and the per-stage ``free_at`` replica scan all run
vectorized over numpy buffers/arrays that parallel the per-stage queues.
"""
from __future__ import annotations

import heapq
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster import ClusterConfig, ClusterModel, single
from repro_torch.core.pipeline import PipelineConfig, PipelineModel, StageConfig
from repro_torch.core.queueing import wait_bound
from repro_torch.serving.request import Request, RequestPool

_EPS = 1e-12
_INF = float("inf")
# replica-fleet size beyond which the free_at dispatch scan lifts the ready
# times into an ndarray: below this, python list scans beat numpy's per-op
# overhead (same tradeoff as the _StageQueue columns)
_NP_SCAN_MIN = 24


class CoreBudgetExceeded(RuntimeError):
    """A reconfigure asked for more cores than the shared pool has left."""


class _FloatBuf:
    """Growable float64 buffer (amortized O(1) append, vectorized extend)."""

    __slots__ = ("_data", "_n")

    def __init__(self, cap: int = 256):
        self._data = np.empty(cap, dtype=np.float64)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def _grow_to(self, need: int) -> None:
        cap = len(self._data)
        if need > cap:
            new = np.empty(max(need, 2 * cap), dtype=np.float64)
            new[:self._n] = self._data[:self._n]
            self._data = new

    def append(self, x: float) -> None:
        self._grow_to(self._n + 1)
        self._data[self._n] = x
        self._n += 1

    def extend(self, xs: np.ndarray) -> None:
        k = len(xs)
        self._grow_to(self._n + k)
        self._data[self._n:self._n + k] = xs
        self._n += k

    def view(self) -> np.ndarray:
        return self._data[:self._n]


class SimMetrics:
    """Aggregate counters; latencies live in a growable float64 buffer so
    per-batch completion extends an array instead of appending Python
    floats one by one."""

    __slots__ = ("_lat", "completed", "dropped", "arrived")

    def __init__(self):
        self._lat = _FloatBuf()
        self.completed = 0
        self.dropped = 0
        self.arrived = 0

    @property
    def latencies(self) -> np.ndarray:
        """Completed-request latencies as a float64 array view."""
        return self._lat.view()

    def sla_violations(self, sla: float) -> float:
        """Fraction of arrived requests violating the SLA (drops count)."""
        if self.arrived == 0:
            return 0.0
        late = int(np.count_nonzero(self._lat.view() > sla))
        return (late + self.dropped) / self.arrived


class _StageQueue:
    """FIFO of requests with parallel columns (absolute arrival time,
    stage-enter time).  Columns are plain lists — batches are small, so
    per-event python appends/slices beat numpy's per-op overhead — and are
    lifted into an ndarray only when a drop scan actually runs, which the
    ``min_arr`` guard makes rare.  ``head`` is a logical front pointer;
    storage compacts lazily."""

    __slots__ = ("reqs", "_arr", "_enter", "head", "min_arr")

    def __init__(self):
        self.reqs: List[Request] = []
        self._arr: List[float] = []
        self._enter: List[float] = []
        self.head = 0
        # conservative lower bound on the oldest live arrival: lets the
        # caller skip the drop scan entirely while nothing can be expired
        self.min_arr = _INF

    def __len__(self) -> int:
        return len(self.reqs) - self.head

    def push(self, req: Request, now: float) -> None:
        self._arr.append(req.arrival)
        self._enter.append(now)
        if req.arrival < self.min_arr:
            self.min_arr = req.arrival
        self.reqs.append(req)

    def push_many(self, reqs: Sequence[Request], arrs: Sequence[float],
                  now: float) -> None:
        """Append a whole upstream batch with its arrival column."""
        self._arr.extend(arrs)
        self._enter.extend([now] * len(reqs))
        m = min(arrs)
        if m < self.min_arr:
            self.min_arr = m
        self.reqs.extend(reqs)

    def head_enter(self) -> float:
        return self._enter[self.head]

    def head_arrival(self) -> float:
        return self._arr[self.head]

    def pop_batch(self, k: int) -> Tuple[List[Request], List[float]]:
        h = self.head
        e = h + k
        batch = self.reqs[h:e]
        arrs = self._arr[h:e]
        self.head = e
        t = len(self.reqs)
        if e == t:
            self.min_arr = _INF
        if e >= 512 and 2 * e >= t:
            del self.reqs[:e]
            del self._arr[:e]
            del self._enter[:e]
            self.head = 0
        return batch, arrs

    def drop_expired(self, now: float, threshold: float) -> List[Request]:
        """Remove (and return) every queued request older than ``threshold``.

        The age test runs vectorized over the arrival column; callers only
        reach this when ``min_arr`` says something may actually be old."""
        h, t = self.head, len(self.reqs)
        if h == t:
            self.min_arr = _INF
            return []
        live_arr = np.array(self._arr[h:t], dtype=np.float64)
        oldest = float(live_arr.min())
        if now - oldest <= threshold:
            self.min_arr = oldest        # tightened bound, nothing expired
            return []
        expired = (now - live_arr) > threshold
        keep = ~expired
        dropped = list(itertools.compress(self.reqs[h:t], expired))
        kept = list(itertools.compress(self.reqs[h:t], keep))
        self.reqs = kept
        self._arr = list(itertools.compress(self._arr[h:t], keep))
        self._enter = list(itertools.compress(self._enter[h:t], keep))
        self.head = 0
        self.min_arr = min(self._arr) if kept else _INF
        return dropped

    def discard_rids(self, rids) -> List[Request]:
        """Remove (and return) every queued request whose ``rid`` is in the
        given set — §4.5 drop propagation purging a cancelled request's
        sibling-branch copies (DAG pipelines only)."""
        h, t = self.head, len(self.reqs)
        live = self.reqs[h:t]
        sel = [r.rid in rids for r in live]
        if not any(sel):
            return []
        keep = [not m for m in sel]
        removed = list(itertools.compress(live, sel))
        self.reqs = list(itertools.compress(live, keep))
        self._arr = list(itertools.compress(self._arr[h:t], keep))
        self._enter = list(itertools.compress(self._enter[h:t], keep))
        self.head = 0
        self.min_arr = min(self._arr) if self.reqs else _INF
        return removed


class ClusterSimulator:
    """All pipelines of a ``ClusterModel`` in one event heap.

    Stages are flattened to global indices (pipeline p's stage i at
    ``_first[p] + i``); every per-stage structure (queue, replica
    ``free_at`` array, generation counter, timeout/wake markers) is one
    flat list over global stages, so the event machinery is exactly the
    single-pipeline machinery run over a larger index space.  Metrics,
    arrival-rate estimates and drop thresholds are per-pipeline.
    """

    def __init__(self, cluster: ClusterModel, config: ClusterConfig,
                 drop_factor: float = 2.0, max_wait: float = 0.5,
                 seed: int = 0, variant_switch_delay: float = 0.0,
                 scale_up_delay: float = 0.0,
                 adaptation_delay: float = 0.0,
                 record_timeline: bool = False,
                 request_pool: Optional[RequestPool] = None):
        """``variant_switch_delay``: cold-start of a stage whose model
        variant changed (container pull + model load; the paper reports an
        ~8 s adaptation process and mitigates pull time with MinIO).
        ``scale_up_delay``: startup of additionally provisioned replicas.
        ``adaptation_delay``: the §5.3 adaptation window — a reconfigured
        pipeline keeps *serving at its old config* for this long before the
        new one takes effect (the decision commits immediately: the replica
        ledger charges the new allocation and ``pipeline_config`` returns
        the target, but queues/batching/service run the old config until
        the deferred ``apply`` event fires).  ``serving_config`` exposes
        what is actually serving; ``reconfig_log`` records every committed
        *decision* as ``(decided_at, pipeline, scheduled_apply_at)`` — a
        decision superseded inside its window keeps its entry (its
        disruption was paid) but its scheduled apply never fires.
        Transition-overlap accounting: during the window the old replica
        fleet is still serving while the new one provisions, so the ledger
        charges the pipeline ``max(old, new)`` cores from the decision
        instant until the apply fires (then drops to the new cost).  A
        grant of a downsizer's freed cores to another pipeline inside the
        window therefore raises ``CoreBudgetExceeded`` *at decision time*
        — instantaneous serving capacity can never exceed C
        (``peak_serving_cores`` is the run's witness; the overlap-aware
        ``optimizer.solve_cluster(..., overlap=True)`` plans against the
        same ``max(old, new)`` charge so its proposals are admissible by
        construction).
        ``record_timeline``: also fill each request's per-stage
        ``stage_enter``/``stage_exit`` dicts (debug/inspection; the hot
        path skips these dict writes — aggregate metrics, drop marks and
        ``done`` stamps are always recorded).
        ``request_pool``: when set, completed/dropped requests are released
        back to the pool at their terminal event — callers that keep
        references to injected requests must not pass a pool."""
        if len(config.pipelines) != len(cluster.pipelines):
            raise ValueError("config/cluster pipeline count mismatch")
        self.cluster = cluster
        self.n_pipelines = len(cluster.pipelines)
        self.core_budget = float(cluster.cores)
        # per-device-class ledger axis (None on a scalar-budget cluster —
        # every vector path below is gated on it, so the single-class run
        # is instruction-for-instruction the legacy scalar ledger)
        self._classes = cluster.device_classes \
            if getattr(cluster, "is_hetero", False) else None
        self._budget_vec = cluster.budget_vector \
            if self._classes is not None else None
        self.drop_factor = drop_factor
        self.max_wait = max_wait
        self.variant_switch_delay = variant_switch_delay
        self.scale_up_delay = scale_up_delay
        self.adaptation_delay = adaptation_delay
        self.record_timeline = record_timeline
        self._pool = request_pool

        # ---- flatten stages to global indices ---------------------------
        self._stage_models = []              # StageModel per global stage
        self._pipe_of: List[int] = []        # owning pipeline per stage
        self._next: List[int] = []           # next global stage (-1 = sink)
        self._first: List[int] = []          # entry stage per pipeline
        self._stages_of: List[range] = []    # global stage range per pipeline
        # DAG topology (chains never consult these beyond the _dag_route
        # bool): children per global stage, parent counts, and whether the
        # owning pipeline routes through the DAG path at all
        self._children: List[Tuple[int, ...]] = []
        self._n_parents: List[int] = []
        self._dag_route: List[bool] = []     # per stage: owner is a DAG
        self._dag_pipe: List[bool] = []      # per pipeline
        for pipe in cluster.pipelines:
            base = len(self._stage_models)
            ns = len(pipe.stages)
            chain = pipe.is_chain
            self._first.append(base)
            self._stages_of.append(range(base, base + ns))
            self._dag_pipe.append(not chain)
            for i, st in enumerate(pipe.stages):
                self._stage_models.append(st)
                self._pipe_of.append(len(self._first) - 1)
                self._next.append(base + i + 1 if i + 1 < ns else -1)
                self._dag_route.append(not chain)
                if chain:
                    self._children.append((base + i + 1,) if i + 1 < ns
                                          else ())
                    self._n_parents.append(1 if i else 0)
                else:
                    self._children.append(tuple(
                        base + c for c in pipe.children_of(i)))
                    self._n_parents.append(len(pipe.parents_of(i)))
        self.n_stages = len(self._stage_models)
        # per-pipeline DAG request tracking: rid counters, in-flight token
        # counts (queued copies + in-service copies + one per partial-join
        # entry), the §4.5-cancelled rid set, and per-join partial buffers
        # (rid -> parents delivered so far)
        self._rid_next: List[int] = [0] * self.n_pipelines
        self._inflight: List[dict] = [{} for _ in range(self.n_pipelines)]
        self._dead: List[set] = [set() for _ in range(self.n_pipelines)]
        self._join_buf: List[Optional[dict]] = [
            {} if n > 1 else None for n in self._n_parents]
        # pooled DAG runs: rid -> Request registry so a request is released
        # exactly once, at full retirement (when its rid leaves
        # ``_inflight``) — never while sibling fan-out copies of the same
        # object are still queued, in service or buffered at a join
        self._req_of: List[dict] = [{} for _ in range(self.n_pipelines)]

        self.configs: List[StageConfig] = []
        for cfg in config.pipelines:
            self.configs.extend(cfg.stages)
        if len(self.configs) != self.n_stages:
            raise ValueError("config/pipeline stage count mismatch")

        self.queues: List[_StageQueue] = [
            _StageQueue() for _ in range(self.n_stages)]
        # per-stage replica ready times; plain lists like the queue columns
        # (replica fleets are usually small, python beats numpy's per-op
        # overhead) — the dispatch scan lifts to a vectorized ndarray pass
        # only past _NP_SCAN_MIN replicas, where batching wins
        self.free_at: List[List[float]] = [
            [0.0] * sc.replicas for sc in self.configs]
        self.rr: List[int] = [0] * self.n_stages
        self.now = 0.0

        # ---- per-pipeline control/metrics state -------------------------
        self.metrics_by_pipe: List[SimMetrics] = [
            SimMetrics() for _ in range(self.n_pipelines)]
        self.sla_of: List[float] = [p.sla for p in cluster.pipelines]
        self._lam_of: List[float] = [10.0] * self.n_pipelines
        # shared-pool replica ledger: cores currently held per pipeline.
        # While a §5.3 adaptation window is in flight this is the
        # transition charge max(serving, committed) — the old fleet still
        # serves while the new one provisions — and drops to the committed
        # cost when the deferred apply fires.  _serving_cost tracks what
        # the serving fleets alone hold (<= _alloc elementwise always).
        self._alloc: List[float] = [
            cfg.cost(pipe) for cfg, pipe
            in zip(config.pipelines, cluster.pipelines)]
        self._serving_cost: List[float] = list(self._alloc)
        if sum(self._alloc) > self.core_budget + 1e-9:
            raise CoreBudgetExceeded(
                f"initial config needs {sum(self._alloc)} cores, "
                f"budget is {self.core_budget}")
        # per-class ledger mirror: one cost vector per pipeline, same
        # max(old, new) transition discipline applied elementwise
        self._alloc_vec: Optional[List[Tuple[float, ...]]] = None
        self._serving_vec: Optional[List[Tuple[float, ...]]] = None
        if self._classes is not None:
            self._alloc_vec = [
                tuple(cfg.cost_by_class(pipe, self._classes))
                for cfg, pipe in zip(config.pipelines, cluster.pipelines)]
            self._serving_vec = list(self._alloc_vec)
            for c, b in enumerate(self._budget_vec):
                tot = sum(v[c] for v in self._alloc_vec)
                if tot > b + 1e-9:
                    raise CoreBudgetExceeded(
                        f"initial config needs {tot} {self._classes[c]} "
                        f"cores, class budget is {b}")
        # invariant witness: sup over time of sum(_serving_cost) — serving
        # cost is piecewise constant between (re)configuration instants, so
        # maxing at every change captures the exact supremum.  A zero-delay
        # *joint* reconfigure is semantically atomic: per-pipeline partial
        # sums mid-loop are states that never existed, so peak sampling is
        # suppressed until the whole joint config has been applied.
        self.peak_serving_cores = float(sum(self._serving_cost))
        self.peak_serving_by_class: Optional[Tuple[float, ...]] = None
        if self._serving_vec is not None:
            self.peak_serving_by_class = tuple(
                sum(v[c] for v in self._serving_vec)
                for c in range(len(self._classes)))
        self._joint_apply = False

        self._events: List[Tuple[float, int, str, object]] = []
        self._seq = itertools.count()
        # injections bypass the heap: adapter/benchmark workloads inject in
        # (near-)sorted time order, so arrivals live in sorted parallel
        # columns (time, entry stage, request) consumed by a front pointer
        # and merged with the heap in run_until.  Parallel lists instead of
        # tuples so ``inject_arrivals`` can bulk-extend a whole decision
        # window's arrivals in three C-level extends (pre-sized batching —
        # no per-request tuple churn).
        self._inj_t: List[float] = []
        self._inj_s: List[int] = []
        self._inj_r: List[Request] = []
        self._inj_i = 0
        self._inj_sorted = True
        # hot-path caches: SLA_P and drop threshold are per-pipeline config
        # constants (flattened per-stage for the dispatch path); per-batch
        # service latency and wait bounds change only on reconfigure /
        # lam_est updates
        self._drop_thr_s: List[float] = [
            drop_factor * self.sla_of[p] for p in self._pipe_of]
        self._lat_tab: List[List[float]] = []
        self._wb: Optional[List[float]] = None
        self._refresh_lat_tab()
        # lazy-cancellation state: one pending timeout/wake marker per stage
        self._gen: List[int] = [0] * self.n_stages
        self._timeout_at: List[float] = [_INF] * self.n_stages
        self._wake_at: List[float] = [_INF] * self.n_stages
        # §5.3 adaptation-window state: committed-but-not-yet-serving config
        # per pipeline, with a generation counter so a superseding decision
        # lazily cancels the stale deferred apply event
        self._pending_cfg: List[Optional[PipelineConfig]] = \
            [None] * self.n_pipelines
        self._pending_gen: List[int] = [0] * self.n_pipelines
        # every committed reconfiguration DECISION, as (decided_at,
        # pipeline, scheduled_apply_at).  Each entry starts an adaptation
        # window (the §5.3 disruption is paid from decided_at); a later
        # decision inside the window supersedes the earlier one, whose
        # scheduled apply then never fires — so this logs decisions made,
        # not rollouts completed, and n_reconfigs == len(reconfig_log)
        self.reconfig_log: List[Tuple[float, int, float]] = []
        self.n_reconfigs = 0
        # observability (benchmarks / invariants)
        self.events_processed = 0
        self.peak_queue_depth = 0
        self.in_service = 0

    # -- control plane --------------------------------------------------
    def reconfigure_pipeline(self, p: int, config: PipelineConfig,
                             _check_budget: bool = True) -> None:
        """Reconfigure one pipeline inside the shared core pool.

        The new allocation must fit in ``core_budget`` minus the other
        pipelines' current allocations (the replica ledger); a violating
        request raises ``CoreBudgetExceeded`` and changes nothing.

        A proposal equal to the committed config is a no-op (it neither
        re-arms timeouts nor counts as a reconfiguration).  With
        ``adaptation_delay > 0`` a genuine change *commits* now (ledger,
        ``pipeline_config``) but the stages keep serving the old config
        until the deferred apply event fires ``adaptation_delay`` later;
        re-proposing the serving config mid-transition cancels the pending
        rollout instead of scheduling a new one.  The ledger charge
        through the window is ``max(serving, new)`` — the old fleet serves
        it out while the new one provisions — so an overlapping grant of
        not-yet-freed cores is rejected here, at decision time.
        """
        pipe = self.cluster.pipelines[p]
        if len(config.stages) != len(pipe.stages):
            raise ValueError("config/pipeline stage count mismatch")
        if config == self.pipeline_config(p):     # committed already
            return
        new_cost = config.cost(pipe)
        if self.adaptation_delay > 0:
            trans_cost = max(self._serving_cost[p], new_cost)
        else:
            trans_cost = new_cost
        trans_vec: Optional[Tuple[float, ...]] = None
        if self._classes is not None:
            new_vec = config.cost_by_class(pipe, self._classes)
            if self.adaptation_delay > 0:
                trans_vec = tuple(max(a, b) for a, b
                                  in zip(self._serving_vec[p], new_vec))
            else:
                trans_vec = new_vec
        if _check_budget:
            others = sum(self._alloc) - self._alloc[p]
            if others + trans_cost > self.core_budget + 1e-9:
                raise CoreBudgetExceeded(
                    f"pipeline {p} wants {trans_cost} cores through its "
                    f"transition but only {self.core_budget - others} of "
                    f"{self.core_budget} are unallocated")
            if trans_vec is not None:
                for c, b in enumerate(self._budget_vec):
                    oth = sum(v[c] for v in self._alloc_vec) \
                        - self._alloc_vec[p][c]
                    if oth + trans_vec[c] > b + 1e-9:
                        raise CoreBudgetExceeded(
                            f"pipeline {p} wants {trans_vec[c]} "
                            f"{self._classes[c]} cores through its "
                            f"transition but only {b - oth} of {b} are "
                            f"unallocated")
        self._alloc[p] = trans_cost
        if trans_vec is not None:
            self._alloc_vec[p] = trans_vec
        if self._pending_cfg[p] is not None and \
                config == self.serving_config(p):
            # revert to what is already serving: cancel the pending rollout
            # (the cancel itself starts no new adaptation window, so it adds
            # no log entry; the aborted decision's entry remains, its
            # scheduled apply never fires)
            self._pending_cfg[p] = None
            self._pending_gen[p] += 1
            return
        self.n_reconfigs += 1
        if self.adaptation_delay > 0:
            apply_at = self.now + self.adaptation_delay
            self._pending_cfg[p] = config
            self._pending_gen[p] += 1
            self._push(apply_at, "apply", (p, self._pending_gen[p]))
            self.reconfig_log.append((self.now, p, apply_at))
            return
        self.reconfig_log.append((self.now, p, self.now))
        self._apply_pipeline_config(p, config)

    def _apply_pipeline_config(self, p: int, config: PipelineConfig) -> None:
        """Make ``config`` the serving configuration of pipeline ``p``
        (immediately at zero adaptation delay, else at the deferred apply
        event)."""
        for s, sc in zip(self._stages_of[p], config.stages):
            old = self.free_at[s]
            n = sc.replicas
            switched = sc.variant != self.configs[s].variant
            if switched and self.variant_switch_delay > 0:
                # cold start: every replica of the stage reloads the model
                ready = self.now + self.variant_switch_delay
                old[:] = [max(t, ready) for t in old]
            if n >= len(old):
                start = self.now + (self.variant_switch_delay if switched
                                    else self.scale_up_delay)
                old.extend([start] * (n - len(old)))
            else:
                # keep the soonest-free replicas
                old.sort()
                del old[n:]
            self.configs[s] = sc
            # batch size / replica availability changed: pending deadlines
            # are stale, re-arm from current state
            self._bump(s)
            self._wake_at[s] = _INF
        # the old fleet stops serving here: settle the ledger from the
        # transition charge max(old, new) down to the new steady-state cost
        cost = config.cost(self.cluster.pipelines[p])
        self._alloc[p] = cost
        self._serving_cost[p] = cost
        if self._classes is not None:
            vec = tuple(config.cost_by_class(self.cluster.pipelines[p],
                                             self._classes))
            self._alloc_vec[p] = vec
            self._serving_vec[p] = vec
        if not self._joint_apply:
            self._note_serving_peak()
        self._refresh_lat_tab(self._stages_of[p])
        self._wb = None
        for s in self._stages_of[p]:
            self._try_dispatch(s)

    def reconfigure(self, config: ClusterConfig) -> None:
        """Atomically reconfigure every pipeline to a joint configuration.

        With ``adaptation_delay > 0`` the admission check is the
        *transition* cost — every changed pipeline charged
        ``max(serving, new)`` through its window — so a joint proposal
        that only fits after the windows close is rejected now, not
        silently over-committed mid-window."""
        cost = self.transition_cost(config)
        if cost > self.core_budget + 1e-9:
            raise CoreBudgetExceeded(
                f"joint config needs {cost} cores through its transition, "
                f"budget is {self.core_budget}")
        if self._classes is not None and not self.fits_transition(config):
            raise CoreBudgetExceeded(
                "joint config exceeds a device-class budget through its "
                "transition")
        self._joint_apply = True
        try:
            for p, cfg in enumerate(config.pipelines):
                self.reconfigure_pipeline(p, cfg, _check_budget=False)
        finally:
            self._joint_apply = False
        self._note_serving_peak()

    def set_lam_est(self, p: int, v: float) -> None:
        """Update pipeline ``p``'s arrival-rate estimate (re-arms pending
        batch-formation timeouts, whose Eq. 7 deadline depends on it)."""
        v = float(v)
        if v == self._lam_of[p]:
            return
        self._lam_of[p] = v
        self._wb = None                  # wait bounds depend on lambda
        # pending batch-formation timeouts were armed under the old lambda;
        # supersede and re-arm them so the deadline tracks the new Eq. 7
        # bound (the legacy core re-evaluated the bound on every tick)
        for s in self._stages_of[p]:
            if self._timeout_at[s] != _INF:
                self._bump(s)
                self._try_dispatch(s)

    # -- invariants / observability --------------------------------------
    @property
    def queued(self) -> int:
        return sum(len(q) for q in self.queues)

    @property
    def allocated_cores(self) -> float:
        """Cores currently held across all pipelines (the ledger total,
        transition charges included)."""
        return float(sum(self._alloc))

    @property
    def serving_cores(self) -> float:
        """Cores the currently *serving* replica fleets hold — during a
        §5.3 window this is the old fleets' total, which the ledger's
        ``max(old, new)`` charge bounds from above, so
        ``serving_cores <= allocated_cores <= core_budget`` always."""
        return float(sum(self._serving_cost))

    def _note_serving_peak(self) -> None:
        total = sum(self._serving_cost)
        if total > self.peak_serving_cores:
            self.peak_serving_cores = total
        if self._serving_vec is not None:
            self.peak_serving_by_class = tuple(
                max(p, sum(v[c] for v in self._serving_vec))
                for c, p in enumerate(self.peak_serving_by_class))

    @property
    def serving_cluster_config(self) -> ClusterConfig:
        """The joint configuration the stages are actually serving right
        now (per-pipeline ``serving_config``)."""
        return ClusterConfig(tuple(self.serving_config(p)
                                   for p in range(self.n_pipelines)))

    def transition_cost(self, config: ClusterConfig) -> float:
        """Cores a joint reconfiguration to ``config`` would hold through
        its §5.3 adaptation windows: each pipeline charged
        ``max(serving, new)`` — delegated to
        ``ClusterConfig.transition_cost`` against the serving config (at
        zero adaptation delay there is no window and this is just
        ``config.cost``).  ``fits_transition`` is the admission predicate
        the adapter checks before applying a joint proposal."""
        if self.adaptation_delay <= 0:
            return config.cost(self.cluster)
        return config.transition_cost(self.cluster,
                                      self.serving_cluster_config)

    def fits_transition(self, config: ClusterConfig) -> bool:
        """Does reconfiguring to ``config`` fit the core budget throughout
        its adaptation windows (not merely after them)?"""
        if self.adaptation_delay <= 0:
            return config.fits(self.cluster)
        return config.fits_transition(self.cluster,
                                      self.serving_cluster_config)

    def pipeline_config(self, p: int) -> PipelineConfig:
        """The configuration pipeline ``p`` is *committed* to: the pending
        transition target while an adaptation window is in flight, else the
        serving config.  This is what the replica ledger charges and what a
        holding adapter must re-propose — holding the serving (pre-
        transition) config instead would cancel an in-flight rollout."""
        pending = self._pending_cfg[p]
        if pending is not None:
            return pending
        return PipelineConfig(tuple(self.configs[s]
                                    for s in self._stages_of[p]))

    def serving_config(self, p: int) -> PipelineConfig:
        """The configuration pipeline ``p``'s stages are actually serving
        right now (the old config while a transition is in flight)."""
        return PipelineConfig(tuple(self.configs[s]
                                    for s in self._stages_of[p]))

    @property
    def current_config(self) -> ClusterConfig:
        """The joint configuration the simulator is committed to."""
        return ClusterConfig(tuple(self.pipeline_config(p)
                                   for p in range(self.n_pipelines)))

    # -- hot-path caches --------------------------------------------------
    def _refresh_lat_tab(self, stages=None) -> None:
        """Per-stage service-latency table l_m(k) for k = 0..batch under the
        current variant (one vectorized evaluation per reconfigured stage).

        ``stages``: global stage indices to refresh (default: all) — a
        per-pipeline reconfigure only rebuilds its own stages' tables.
        """
        if stages is None:
            stages = range(self.n_stages)
            self._lat_tab = [None] * self.n_stages
            self._batch_of = [0] * self.n_stages
        for s in stages:
            st, sc = self._stage_models[s], self.configs[s]
            ks = np.arange(sc.batch + 1, dtype=np.float64)
            ks[0] = 1.0                  # k=0 never dispatched; keep finite
            self._lat_tab[s] = \
                st.variant(sc.variant).latency(ks, sc.device).tolist()
            self._batch_of[s] = sc.batch

    def _wait_bounds(self) -> List[float]:
        if self._wb is None:
            self._wb = [wait_bound(sc.batch, self._lam_of[p], self.max_wait)
                        for sc, p in zip(self.configs, self._pipe_of)]
        return self._wb

    # -- event machinery --------------------------------------------------
    def _push(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    def _bump(self, s: int) -> None:
        """Supersede any pending timeout for stage ``s`` (lazy cancel)."""
        self._gen[s] += 1
        self._timeout_at[s] = _INF

    def _schedule_timeout(self, s: int, t: float) -> None:
        if t < self._timeout_at[s] - _EPS:
            self._timeout_at[s] = t
            self._push(t, "timeout", (s, self._gen[s]))

    def _schedule_wake(self, s: int, t: float) -> None:
        if t <= self.now + _EPS:
            t = self.now + 1e-9
        if t < self._wake_at[s] - _EPS:
            self._wake_at[s] = t
            self._push(t, "wake", s)

    def inject(self, req: Request, pipeline: int = 0) -> None:
        self.metrics_by_pipe[pipeline].arrived += 1
        t = req.arrival
        ts = self._inj_t
        if ts and t < ts[-1]:
            self._inj_sorted = False
        ts.append(t)
        self._inj_s.append(self._first[pipeline])
        self._inj_r.append(req)

    def inject_arrivals(self, times: Sequence[float],
                        pipeline: int = 0) -> None:
        """Bulk-inject one pipeline's arrivals for a whole decision window.

        The pre-sized batching path the adapters use: one vectorized
        order check plus three C-level list extends replace a per-request
        python loop of ``inject`` calls (tuple build, sortedness check and
        metrics bump each).  Requests are acquired from the attached
        ``request_pool`` in one bulk pass when the simulator has one
        (``RequestPool.acquire_many``), else freshly allocated; each
        carries its pipeline's SLA, exactly as the per-request path.
        Equivalent to ``inject`` call-for-call — the equivalence tests pin
        identical metrics and latency streams.
        """
        times = np.asarray(times, dtype=np.float64)
        k = times.size
        if k == 0:
            return
        ts = times.tolist()
        col = self._inj_t
        if (col and ts[0] < col[-1]) or \
                (k > 1 and bool(np.any(times[1:] < times[:-1]))):
            self._inj_sorted = False
        self.metrics_by_pipe[pipeline].arrived += k
        sla = self.sla_of[pipeline]
        if self._pool is not None:
            reqs = self._pool.acquire_many(ts, sla)
        else:
            reqs = [Request(arrival=t, sla=sla) for t in ts]
        col.extend(ts)
        self._inj_s.extend([self._first[pipeline]] * k)
        self._inj_r.extend(reqs)

    def _stage_latency(self, s: int, k: int) -> float:
        tab = self._lat_tab[s]
        if k < len(tab):
            return tab[k]
        sc = self.configs[s]
        v = self._stage_models[s].variant(sc.variant)
        return float(v.latency(max(k, 1), sc.device))

    def _try_dispatch(self, s: int) -> None:
        q = self.queues[s]
        now = self.now
        # §4.5 drop policy — the min-arrival bound lets the common
        # nothing-to-expire case skip the vectorized scan entirely
        thr = self._drop_thr_s[s]
        if now - q.min_arr > thr:
            dropped = q.drop_expired(now, thr)
            if dropped:
                for r in dropped:
                    r.dropped_at = s
                    r.done = now
                self.metrics_by_pipe[self._pipe_of[s]].dropped += len(dropped)
                self._bump(s)
                if self._dag_route[s]:
                    # §4.5 drop propagation: cancel the sibling branches'
                    # in-flight copies of every dropped request.  Pool
                    # release happens inside the cancel path at full
                    # retirement — sibling copies of the same object may
                    # still be in flight here
                    self._dag_cancel(s, [r.rid for r in dropped])
                elif self._pool is not None:
                    self._pool.release_many(dropped)
        nq = len(q.reqs) - q.head
        if not nq:
            return
        batch_sz = self.configs[s].batch
        free = self.free_at[s]
        limit = now + _EPS
        # hot-loop locals: every dispatched batch costs one heap push, one
        # replica-slot write and one generation bump
        tab = self._lat_tab[s]
        tab_n = len(tab)
        events = self._events
        seq = self._seq
        push = heapq.heappush
        gen = self._gen
        while nq:
            if nq < batch_sz:
                # a forming batch waits for its Eq. 7 deadline before the
                # replica state matters: dispatch happens at
                # max(deadline, soonest-free) either way, so checking the
                # deadline first skips the replica scan on the (common)
                # still-forming path
                deadline = q.head_enter() + self._wait_bounds()[s]
                if now < deadline - _EPS:
                    self._schedule_timeout(s, deadline)
                    return
                k = nq
            else:
                k = batch_sz
            nf = len(free)
            if nf == 0:
                # zero replicas configured: requests can only age out
                self._schedule_wake(s, q.head_arrival() + thr)
                return
            if nf > _NP_SCAN_MIN:
                # large fleet: one vectorized pass over the ready times
                arr = np.asarray(free)
                avail = (arr <= limit).nonzero()[0]
                n_avail = avail.size
                if n_avail == 0:
                    self._schedule_wake(s, float(arr.min()))
                    return
                rep = int(avail[self.rr[s] % n_avail])
            else:
                avail = [i for i, t in enumerate(free) if t <= limit]
                n_avail = len(avail)
                if n_avail == 0:
                    self._schedule_wake(s, min(free))
                    return
                rep = avail[self.rr[s] % n_avail]
            batch, arrs = q.pop_batch(k)
            nq -= k
            self.rr[s] += 1
            done_t = now + (tab[k] if k < tab_n
                            else self._stage_latency(s, k))
            free[rep] = done_t
            self.in_service += k
            push(events, (done_t, next(seq), "done", (s, batch, arrs)))
            gen[s] += 1                  # inlined _bump (lazy cancel)
            self._timeout_at[s] = _INF

    def _handle(self, kind: str, payload) -> None:
        if kind == "arrive":
            s, reqs, arrs = payload
            q = self.queues[s]
            if self._dag_route[s] and self._n_parents[s] == 0:
                # DAG pipeline entry: stamp per-pipeline request ids (join
                # matching / drop propagation) and open the token count
                p = self._pipe_of[s]
                infl = self._inflight[p]
                rid = self._rid_next[p]
                for r in reqs:
                    r.rid = rid
                    infl[rid] = 1
                    rid += 1
                self._rid_next[p] = rid
                if self._pool is not None:
                    reg = self._req_of[p]
                    for r in reqs:
                        reg[r.rid] = r
            if arrs is None:
                for r in reqs:
                    q.push(r, self.now)
            else:
                q.push_many(reqs, arrs, self.now)
            if self.record_timeline:
                for r in reqs:
                    r.stage_enter[s] = self.now
            d = len(q.reqs) - q.head
            if d > self.peak_queue_depth:
                self.peak_queue_depth = d
            # fast path: the batch is still forming (not full), its head is
            # unchanged and already has a live timeout armed, and nothing
            # can have expired — this arrival cannot trigger a dispatch
            if (d >= self._batch_of[s]
                    or self._timeout_at[s] == _INF
                    or self.now - q.min_arr > self._drop_thr_s[s]):
                self._try_dispatch(s)
        elif kind == "done":
            s, batch, arrs = payload
            self.in_service -= len(batch)
            if self.record_timeline:
                for r in batch:
                    r.stage_exit[s] = self.now
            if self._dag_route[s]:
                self._done_dag(s, batch, arrs)
            else:
                nxt = self._next[s]
                if nxt >= 0:
                    # synchronous handoff: the next-stage arrival is at
                    # this same instant, so deliver it directly instead of
                    # taking a round-trip through the heap
                    self._handle("arrive", (nxt, batch, arrs))
                else:
                    now = self.now
                    for r in batch:
                        r.done = now
                    m = self.metrics_by_pipe[self._pipe_of[s]]
                    m.completed += len(batch)
                    m._lat.extend([now - a for a in arrs])
                    if self._pool is not None:
                        self._pool.release_many(batch)
            q = self.queues[s]
            if len(q.reqs) > q.head:         # freed replica, waiting work
                self._try_dispatch(s)
        elif kind == "timeout":
            s, gen = payload
            if self._timeout_at[s] <= self.now + _EPS:
                self._timeout_at[s] = _INF
            if gen == self._gen[s]:          # else: superseded, ignore
                q = self.queues[s]
                if len(q.reqs) > q.head:
                    self._try_dispatch(s)
        elif kind == "wake":
            s = payload
            if self._wake_at[s] <= self.now + _EPS:
                self._wake_at[s] = _INF
            q = self.queues[s]
            if len(q.reqs) > q.head:
                self._try_dispatch(s)
        elif kind == "apply":
            # end of a §5.3 adaptation window: the committed config starts
            # serving (stale events from superseded decisions are ignored
            # via the pipeline generation counter)
            p, gen = payload
            if gen == self._pending_gen[p] and self._pending_cfg[p] is not None:
                cfg = self._pending_cfg[p]
                self._pending_cfg[p] = None
                self._apply_pipeline_config(p, cfg)

    # -- DAG routing (stages whose owning pipeline is not a chain) ---------
    #
    # Fan-out: a completed batch is replicated to every child (the same
    # Request objects — each queued copy, in-service copy and partial-join
    # entry carries one token in the per-pipeline ``_inflight`` count).  A
    # join (>1 parents) buffers per-request delivery counts keyed by rid
    # and enqueues the request only when its *last* parent delivers
    # (wait-for-all-parents).  A §4.5 drop of any copy cancels the whole
    # request: its rid joins ``_dead``, sibling queued copies and join
    # partials are purged immediately, and in-service copies are discarded
    # when their batch completes.  Chains never enter any of this — their
    # event path above is untouched (the equivalence tests pin
    # bit-identity).
    def _dec_token(self, p: int, rid: int) -> None:
        infl = self._inflight[p]
        n = infl[rid] - 1
        if n:
            infl[rid] = n
        else:
            del infl[rid]
            self._dead[p].discard(rid)
            if self._pool is not None:   # last copy gone: fully retired
                self._pool.release(self._req_of[p].pop(rid))

    def _done_dag(self, s: int, batch, arrs) -> None:
        p = self._pipe_of[s]
        infl = self._inflight[p]
        dead = self._dead[p]
        now = self.now
        if dead:
            alive, alive_arrs = [], []
            for r, a in zip(batch, arrs):
                if r.rid in dead:            # cancelled mid-service
                    self._dec_token(p, r.rid)
                else:
                    alive.append(r)
                    alive_arrs.append(a)
        else:
            alive, alive_arrs = list(batch), list(arrs)
        if not alive:
            return
        children = self._children[s]
        if not children:                     # sink: the request completes
            for r in alive:
                r.done = now
                del infl[r.rid]
            m = self.metrics_by_pipe[p]
            m.completed += len(alive)
            m._lat.extend([now - a for a in alive_arrs])
            if self._pool is not None:       # single sink: last copy each
                reg = self._req_of[p]
                for r in alive:
                    del reg[r.rid]
                self._pool.release_many(alive)
            return
        if len(children) > 1:                # fan-out: one token per copy
            extra = len(children) - 1
            for r in alive:
                infl[r.rid] += extra
        for c in children:
            if dead:
                # a drop during an earlier child's dispatch may have
                # cancelled requests this child still expects a copy of
                live_r, live_a = [], []
                for r, a in zip(alive, alive_arrs):
                    if r.rid in dead:
                        self._dec_token(p, r.rid)
                    else:
                        live_r.append(r)
                        live_a.append(a)
                if not live_r:
                    continue
            else:
                live_r, live_a = alive, alive_arrs
            if self._n_parents[c] > 1:
                self._deliver_join(c, live_r, live_a)
            else:
                self._handle("arrive", (c, live_r, live_a))

    def _deliver_join(self, c: int, reqs, arrs) -> None:
        """Wait-for-all-parents: buffer per-parent deliveries by rid; the
        request enters the join queue (with its original arrival time, in
        delivering-batch order) only when its last parent delivers."""
        buf = self._join_buf[c]
        need = self._n_parents[c]
        infl = self._inflight[self._pipe_of[c]]
        ready, ready_arrs = [], []
        for r, a in zip(reqs, arrs):
            cnt = buf.get(r.rid, 0) + 1
            if cnt < need:
                buf[r.rid] = cnt
                if cnt > 1:                  # absorbed into the one entry
                    infl[r.rid] -= 1
            else:                            # last parent: release to queue
                del buf[r.rid]
                infl[r.rid] -= 1             # entry + copy -> queued once
                ready.append(r)
                ready_arrs.append(a)
        if ready:
            self._handle("arrive", (c, ready, ready_arrs))

    def _dag_cancel(self, s: int, rids) -> None:
        """§4.5 drop propagation: requests dropped at stage ``s`` are dead
        everywhere — purge their queued sibling copies and join partials
        now; in-service copies are discarded at their done event."""
        p = self._pipe_of[s]
        infl = self._inflight[p]
        dead = self._dead[p]
        purge = set()
        for rid in rids:
            n = infl[rid] - 1
            if n:                            # copies still out there
                infl[rid] = n
                dead.add(rid)
                purge.add(rid)
            else:
                del infl[rid]
                if self._pool is not None:   # no other copies: retired now
                    self._pool.release(self._req_of[p].pop(rid))
        if not purge:
            return
        for j in self._stages_of[p]:
            if j == s:
                continue
            buf = self._join_buf[j]
            if buf:
                for rid in purge.intersection(buf):
                    del buf[rid]
                    self._dec_token(p, rid)
            q = self.queues[j]
            if len(q):
                removed = q.discard_rids(purge)
                if removed:
                    for r in removed:
                        self._dec_token(p, r.rid)
                    # queue shrank under a possibly armed timeout: re-arm
                    # from current state (and dispatch if past the deadline)
                    self._bump(j)
                    self._try_dispatch(j)

    def run_until(self, t_end: float) -> None:
        ev = self._events
        inj_t, inj_s, inj_r = self._inj_t, self._inj_s, self._inj_r
        if not self._inj_sorted:
            # compact the consumed prefix BEFORE sorting, or processed
            # arrivals would be shuffled back past the front pointer
            if self._inj_i:
                del inj_t[:self._inj_i]
                del inj_s[:self._inj_i]
                del inj_r[:self._inj_i]
                self._inj_i = 0
            # stable sort of the parallel columns by time (FIFO among
            # equal-time arrivals, like the old tuple sort keyed on t)
            order = sorted(range(len(inj_t)), key=inj_t.__getitem__)
            inj_t[:] = [inj_t[j] for j in order]
            inj_s[:] = [inj_s[j] for j in order]
            inj_r[:] = [inj_r[j] for j in order]
            self._inj_sorted = True
        i = self._inj_i
        n_inj = len(inj_t)
        pop = heapq.heappop
        handle = self._handle            # resolves subclass overrides once
        n_ev = 0
        while True:
            t_inj = inj_t[i] if i < n_inj else _INF
            if ev and ev[0][0] < t_inj:
                t = ev[0][0]
                if t > t_end:
                    break
                _, _, kind, payload = pop(ev)
                n_ev += 1
                if t > self.now:
                    self.now = t
                handle(kind, payload)
            elif t_inj <= t_end:
                # injection stream wins ties: matches the legacy ordering
                # where arrivals were heap-pushed before any derived event
                n_ev += 1
                if t_inj > self.now:
                    self.now = t_inj
                handle("arrive", (inj_s[i], (inj_r[i],), None))
                i += 1
            else:
                break
        self.events_processed += n_ev
        if i > 4096 and 2 * i >= n_inj:
            del inj_t[:i]
            del inj_s[:i]
            del inj_r[:i]
            i = 0
        self._inj_i = i
        if t_end > self.now:             # never rewind the event clock
            self.now = t_end


# ---------------------------------------------------------------------------
# structured-array event core
#
# The heapq core above pays per-event python on every arrival: a string-kind
# _handle dispatch, a per-request queue append, a Request object, and (under
# load) a _try_dispatch call that usually changes nothing.  At BENCH_scale
# (tens of thousands of arrivals per decision window) that per-arrival python
# IS the wall time — profiling shows the heap's C ops are <10% of it.  The
# structured core below keeps the exact event semantics but stores arrivals
# and stage queues as parallel numpy columns and delivers whole *runs* of
# arrivals (every injected arrival up to the next heap event) in vectorized
# bulk, computing analytically the first arrival that could change simulator
# state (fill a batch, arm a timeout, free a replica at a wake tie, or cross
# the §4.5 drop threshold) and handing only *that* one to the exact
# per-event path.  Every run it delivers is therefore event-for-event
# identical to the heapq core — the equivalence suite pins completed /
# dropped / latency streams / events_processed / reconfig_log bit-identical.
# ---------------------------------------------------------------------------

_EV_DONE, _EV_TIMEOUT, _EV_WAKE, _EV_APPLY = 0, 1, 2, 3
_KIND_IDS = {"done": _EV_DONE, "timeout": _EV_TIMEOUT,
             "wake": _EV_WAKE, "apply": _EV_APPLY}


class _EventColumns:
    """Pending derived events as parallel columns (time / kind / payload)
    indexed by slot, with a ``(time, seq, slot)`` heap over the slots and
    batch-pop of same-timestamp events.

    The heap tuples carry only scalars — comparisons never touch payload
    objects — and ``pop_batch`` drains every event sharing the head
    timestamp in one call (seq order, i.e. push order, preserved), so the
    run loop crosses the python/numpy boundary once per *timestamp*, not
    once per event."""

    __slots__ = ("kind", "pay", "_heap", "_free", "_seq")

    def __init__(self, cap: int = 256):
        self.kind = np.zeros(cap, dtype=np.int8)
        self.pay: List[object] = [None] * cap
        self._free = list(range(cap - 1, -1, -1))
        self._heap: List[Tuple[float, int, int]] = []
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, t: float, kind: int, payload) -> None:
        free = self._free
        if not free:
            cap = len(self.pay)
            grown = np.zeros(2 * cap, dtype=np.int8)
            grown[:cap] = self.kind
            self.kind = grown
            self.pay.extend([None] * cap)
            free.extend(range(2 * cap - 1, cap - 1, -1))
        slot = free.pop()
        self.kind[slot] = kind
        self.pay[slot] = payload
        heapq.heappush(self._heap, (t, next(self._seq), slot))

    def head_time(self) -> float:
        h = self._heap
        return h[0][0] if h else _INF

    def pop_batch(self) -> Tuple[float, List[int], List[object]]:
        """Pop every event sharing the head timestamp, in seq order."""
        h = self._heap
        pop = heapq.heappop
        t0, _, slot = pop(h)
        kinds = [int(self.kind[slot])]
        pays = [self.pay[slot]]
        self.pay[slot] = None
        self._free.append(slot)
        while h and h[0][0] == t0:
            _, _, slot = pop(h)
            kinds.append(int(self.kind[slot]))
            pays.append(self.pay[slot])
            self.pay[slot] = None
            self._free.append(slot)
        return t0, kinds, pays


class _ArrayStageQueue:
    """The struct core's stage queue: growable float64 parallel columns
    (absolute arrival time, stage-enter time) with a logical front pointer
    — no per-request python objects.  Batch pops, §4.5 drop scans and
    completion accounting all run as numpy slice ops."""

    __slots__ = ("_arr", "_enter", "_rid", "head", "n", "min_arr",
                 "sorted_fifo", "fifo_ok")

    def __init__(self, cap: int = 64, sorted_fifo: bool = False,
                 track_rid: bool = False):
        self._arr = np.empty(cap, dtype=np.float64)
        self._enter = np.empty(cap, dtype=np.float64)
        # DAG stages carry a third parallel column: the per-pipeline
        # request id (join matching + §4.5 drop propagation); chain stages
        # skip the column entirely
        self._rid = np.empty(cap, dtype=np.int64) if track_rid else None
        self.head = 0
        self.n = 0
        self.min_arr = _INF
        # first-stage queues normally receive ascending arrival times
        # (sorted injections + FIFO pops), so their drop scan is a prefix
        # search and min_arr is exact rather than a conservative bound.
        # ``fifo_ok`` tracks whether that holds *right now*: a stale
        # arrival injected after the clock passed it (a later run_until
        # delivering times older than what's already queued) breaks the
        # ascending order, degrading the queue to the masked scan until
        # it next empties.
        self.sorted_fifo = sorted_fifo
        self.fifo_ok = sorted_fifo

    def __len__(self) -> int:
        return self.n - self.head

    def _room(self, k: int) -> None:
        cap = self._arr.size
        if self.n + k <= cap:
            return
        live = self.n - self.head
        new_cap = max(2 * cap, live + k)
        na = np.empty(new_cap, dtype=np.float64)
        ne = np.empty(new_cap, dtype=np.float64)
        na[:live] = self._arr[self.head:self.n]
        ne[:live] = self._enter[self.head:self.n]
        if self._rid is not None:
            nr = np.empty(new_cap, dtype=np.int64)
            nr[:live] = self._rid[self.head:self.n]
            self._rid = nr
        self._arr = na
        self._enter = ne
        self.head = 0
        self.n = live

    def push_scalar(self, arrival: float, enter: float,
                    rid: int = -1) -> None:
        self._room(1)
        n = self.n
        if self.fifo_ok and n > self.head and arrival < self._arr[n - 1]:
            self.fifo_ok = False
        self._arr[n] = arrival
        self._enter[n] = enter
        if self._rid is not None:
            self._rid[n] = rid
        self.n = n + 1
        if arrival < self.min_arr:
            self.min_arr = arrival

    def push_bulk(self, arrivals: np.ndarray, enter,
                  rids: Optional[np.ndarray] = None,
                  ascending: bool = False) -> None:
        """Append a block of arrivals; ``enter`` may be a scalar (upstream
        handoff: the whole batch enters now) or a parallel array (bulk
        injection of stale + fresh arrivals).  A sorted_fifo queue only
        ever receives ascending blocks, so the min is the first element;
        handoff batches popped from a non-first stage can be out of order
        (completions overtake) and need the full scan — unless the caller
        proves the block ascending (``ascending=True``: a FIFO pop from a
        still-sorted queue, as the round core's chain loop tracks)."""
        k = arrivals.size
        self._room(k)
        n = self.n
        if self.fifo_ok and n > self.head and arrivals[0] < self._arr[n - 1]:
            self.fifo_ok = False
        self._arr[n:n + k] = arrivals
        self._enter[n:n + k] = enter
        if self._rid is not None:
            self._rid[n:n + k] = rids
        self.n = n + k
        m = float(arrivals[0]) if (self.sorted_fifo or ascending) \
            else float(arrivals.min())
        if m < self.min_arr:
            self.min_arr = m

    def head_enter(self) -> float:
        return self._enter[self.head]

    def head_arrival(self) -> float:
        return self._arr[self.head]

    def pop_batch(self, k: int) -> np.ndarray:
        h = self.head
        e = h + k
        arrs = self._arr[h:e].copy()
        self.head = e
        if e == self.n:
            self.min_arr = _INF
            self.head = self.n = 0
            self.fifo_ok = self.sorted_fifo
        elif e >= 4096 and 2 * e >= self.n:
            live = self.n - e
            self._arr[:live] = self._arr[e:self.n].copy()
            self._enter[:live] = self._enter[e:self.n].copy()
            if self._rid is not None:
                self._rid[:live] = self._rid[e:self.n].copy()
            self.head = 0
            self.n = live
        return arrs

    def pop_batch_rid(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """``pop_batch`` plus the batch's rid column (DAG stages only)."""
        h = self.head
        rids = self._rid[h:h + k].copy()
        return self.pop_batch(k), rids

    def drop_expired_rid(self, now: float, threshold: float) -> np.ndarray:
        """``drop_expired`` returning the dropped requests' rids (DAG
        stages only) — same drop set, same tightened-``min_arr`` semantics
        on both the prefix and the masked path."""
        h = self.head
        rid = self._rid
        if self.fifo_ok:
            k = self.drop_expired(now, threshold)
            return rid[h:h + k].copy()   # prefix drop: head advanced by k
        t = self.n
        live = self._arr[h:t]
        keep = (now - live) <= threshold
        dropped = rid[h:t][~keep].copy()
        if dropped.size:
            # masked compaction must carry the rid column along
            rid[:t - h - dropped.size] = rid[h:t][keep]
        self.drop_expired(now, threshold)
        return dropped

    def discard_rids(self, rids) -> np.ndarray:
        """Remove (and return the rids of) every queued request whose rid
        is in the given set — §4.5 drop propagation purging a cancelled
        request's sibling-branch copies.  Removal preserves arrival order,
        so ``fifo_ok`` survives."""
        h, t = self.head, self.n
        live_rid = self._rid[h:t]
        sel = np.fromiter((int(r) in rids for r in live_rid),
                          dtype=bool, count=t - h)
        if not sel.any():
            return live_rid[:0]
        keep = ~sel
        removed = live_rid[sel].copy()
        kept_arr = self._arr[h:t][keep]
        k = kept_arr.size
        self._arr[:k] = kept_arr
        self._enter[:k] = self._enter[h:t][keep]
        self._rid[:k] = live_rid[keep]
        self.head = 0
        self.n = k
        if k:
            self.min_arr = float(kept_arr[0] if self.fifo_ok
                                 else kept_arr.min())
        else:
            self.min_arr = _INF
            self.fifo_ok = self.sorted_fifo
        return removed

    def drop_expired(self, now: float, threshold: float) -> int:
        """Drop every queued request older than ``threshold``; returns the
        count (the struct core keeps no per-request objects to return).
        Same tightened-bound semantics as ``_StageQueue.drop_expired`` on
        both paths: while ``fifo_ok`` holds, the prefix search lands on
        the identical drop set and the identical tightened ``min_arr``;
        a queue de-ordered by stale injections takes the masked scan."""
        h, t = self.head, self.n
        if h == t:
            self.min_arr = _INF
            self.fifo_ok = self.sorted_fifo
            return 0
        arr = self._arr
        if self.fifo_ok:
            # expired entries form a prefix of the ascending column; find
            # the cutoff by binary search, then settle the rounding
            # boundary with the reference's exact `now - a > thr` test
            j = h + int(arr[h:t].searchsorted(now - threshold, side="left"))
            while j < t and now - arr[j] > threshold:
                j += 1
            while j > h and not (now - arr[j - 1] > threshold):
                j -= 1
            if j == t:
                self.min_arr = _INF
                self.head = self.n = 0
                self.fifo_ok = self.sorted_fifo
            else:
                self.min_arr = float(arr[j])
                self.head = j
            return j - h
        live = arr[h:t]
        oldest = float(live.min())
        if now - oldest <= threshold:
            self.min_arr = oldest        # tightened bound, nothing expired
            return 0
        keep = (now - live) <= threshold
        kept = live[keep]
        kept_enter = self._enter[h:t][keep]
        k = kept.size
        self._arr[:k] = kept
        self._enter[:k] = kept_enter
        self.head = 0
        self.n = k
        if k:
            self.min_arr = float(kept.min())
        else:
            self.min_arr = _INF
            self.fifo_ok = self.sorted_fifo
        return (t - h) - k


class _StructCore:
    """Mixin implementing the structured-array event core (see the section
    comment above).  Combine with ``ClusterSimulator`` /
    ``PipelineSimulator`` via ``StructClusterSimulator`` /
    ``StructPipelineSimulator``.

    Limitations (by design — the hot path carries no request objects):
    per-request bookkeeping is skipped: ``record_timeline`` is rejected, an
    attached ``request_pool`` is ignored (nothing is acquired or released),
    and ``inject``-ed ``Request`` objects contribute only their arrival
    timestamp (``done``/``dropped_at`` are never written back).  All
    aggregate metrics — completed/dropped/arrived, latency streams,
    ``events_processed``, ``reconfig_log``, peaks — are bit-identical to
    the heapq core."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        if self.record_timeline:
            raise ValueError(
                "the struct event core keeps no per-request objects; "
                "use the heapq core for record_timeline")
        self._pool = None                # never acquire/release requests
        firsts = set(self._first)
        self.queues = [_ArrayStageQueue(sorted_fifo=s in firsts,
                                        track_rid=self._dag_route[s])
                       for s in range(self.n_stages)]
        self._evq = _EventColumns()
        # per-pipeline injected-arrival buffers (arrivals only ever target
        # a pipeline's first stage, so the global merge the heapq core
        # performs is deferred to the trigger heap below)
        P = self.n_pipelines
        self._pt = [np.empty(256, dtype=np.float64) for _ in range(P)]
        self._pi = [0] * P               # consumed-prefix cursor
        self._pn = [0] * P               # logical end
        self._p_unsorted = [False] * P
        # lazy-delivery trigger state: per pipeline, the buffer index of
        # the first arrival needing the exact per-event path (see
        # _first_trigger) and a version counter invalidating stale trigger
        # heap entries; _now0 is the clock at run_until entry (the floor
        # for stage-enter times of stale injections)
        self._next_k = [0] * P
        self._trig_ver = [0] * P
        self._trigh: List[Tuple[float, int, int]] = []
        self._now0 = 0.0
        # inj_pipe[s]: pipeline index when s is its pipeline's first
        # (injection-receiving) stage, else -1
        ip = [-1] * self.n_stages
        for p in range(P):
            ip[self._first[p]] = p
        self._inj_pipe = ip

    # -- event push (string kinds arrive from shared control-plane code) --
    def _push(self, t: float, kind: str, payload) -> None:
        self._evq.push(t, _KIND_IDS[kind], payload)

    # -- injection ----------------------------------------------------------
    def _p_room(self, p: int, k: int) -> None:
        buf = self._pt[p]
        cap = buf.size
        if self._pn[p] + k <= cap:
            return
        i, n = self._pi[p], self._pn[p]
        live = n - i
        nt = np.empty(max(2 * cap, live + k), dtype=np.float64)
        nt[:live] = buf[i:n]
        self._pt[p] = nt
        self._pi[p] = 0
        self._pn[p] = live

    def inject(self, req: Request, pipeline: int = 0) -> None:
        self.metrics_by_pipe[pipeline].arrived += 1
        self._p_room(pipeline, 1)
        t = float(req.arrival)
        n = self._pn[pipeline]
        if n and t < self._pt[pipeline][n - 1]:
            self._p_unsorted[pipeline] = True
        self._pt[pipeline][n] = t
        self._pn[pipeline] = n + 1

    def inject_arrivals(self, times: Sequence[float],
                        pipeline: int = 0) -> None:
        times = np.asarray(times, dtype=np.float64)
        k = times.size
        if k == 0:
            return
        self.metrics_by_pipe[pipeline].arrived += k
        self._p_room(pipeline, k)
        n = self._pn[pipeline]
        buf = self._pt[pipeline]
        if (n and times[0] < buf[n - 1]) or \
                (k > 1 and bool(np.any(times[1:] < times[:-1]))):
            self._p_unsorted[pipeline] = True
        buf[n:n + k] = times
        self._pn[pipeline] = n + k

    # -- the exact per-event paths (mirrors of the heapq core) -------------
    def _arrive_one(self, s: int, t: float) -> None:
        """Deliver one arrival through the exact heapq-core arrive path."""
        q = self.queues[s]
        if self._dag_route[s]:
            # DAG pipeline entry: stamp the per-pipeline request id and
            # open its in-flight token count (mirrors the heapq arrive)
            p = self._pipe_of[s]
            rid = self._rid_next[p]
            self._inflight[p][rid] = 1
            self._rid_next[p] = rid + 1
            q.push_scalar(t, self.now, rid)
        else:
            q.push_scalar(t, self.now)
        d = q.n - q.head
        if d > self.peak_queue_depth:
            self.peak_queue_depth = d
        if (d >= self._batch_of[s]
                or self._timeout_at[s] == _INF
                or self.now - q.min_arr > self._drop_thr_s[s]):
            self._try_dispatch(s)

    def _arrive_batch(self, s: int, arrs: np.ndarray) -> None:
        """Synchronous upstream handoff (the heapq core's push_many path)."""
        q = self.queues[s]
        q.push_bulk(arrs, self.now)
        d = q.n - q.head
        if d > self.peak_queue_depth:
            self.peak_queue_depth = d
        if (d >= self._batch_of[s]
                or self._timeout_at[s] == _INF
                or self.now - q.min_arr > self._drop_thr_s[s]):
            self._try_dispatch(s)

    # -- DAG routing on arrays (mirrors the heapq core's _done_dag /
    # _deliver_join / _dag_cancel, with rid columns instead of Request
    # objects; identical token accounting and delivery order) ------------
    def _arrive_batch_rid(self, s: int, arrs: np.ndarray,
                          rids: np.ndarray) -> None:
        """Synchronous upstream handoff carrying the rid column."""
        q = self.queues[s]
        q.push_bulk(arrs, self.now, rids)
        d = q.n - q.head
        if d > self.peak_queue_depth:
            self.peak_queue_depth = d
        if (d >= self._batch_of[s]
                or self._timeout_at[s] == _INF
                or self.now - q.min_arr > self._drop_thr_s[s]):
            self._try_dispatch(s)

    def _done_dag(self, s: int, arrs: np.ndarray,       # type: ignore[override]
                  rids: np.ndarray) -> None:
        p = self._pipe_of[s]
        infl = self._inflight[p]
        dead = self._dead[p]
        if dead:
            keep = np.fromiter((int(r) not in dead for r in rids),
                               dtype=bool, count=rids.size)
            for r in rids[~keep]:        # cancelled mid-service
                self._dec_token(p, int(r))
            arrs = arrs[keep]
            rids = rids[keep]
        if not arrs.size:
            return
        children = self._children[s]
        if not children:                 # sink: the request completes
            for r in rids:
                del infl[int(r)]
            m = self.metrics_by_pipe[p]
            m.completed += arrs.size
            m._lat.extend(self.now - arrs)
            return
        if len(children) > 1:            # fan-out: one token per copy
            extra = len(children) - 1
            for r in rids:
                infl[int(r)] += extra
        for c in children:
            if dead:
                # a drop during an earlier child's dispatch may have
                # cancelled requests this child still expects a copy of
                keep = np.fromiter((int(r) not in dead for r in rids),
                                   dtype=bool, count=rids.size)
                for r in rids[~keep]:
                    self._dec_token(p, int(r))
                live_a = arrs[keep]
                live_r = rids[keep]
                if not live_a.size:
                    continue
            else:
                live_a, live_r = arrs, rids
            if self._n_parents[c] > 1:
                self._deliver_join(c, live_a, live_r)
            else:
                self._arrive_batch_rid(c, live_a, live_r)

    def _deliver_join(self, c: int, arrs: np.ndarray,   # type: ignore[override]
                      rids: np.ndarray) -> None:
        buf = self._join_buf[c]
        need = self._n_parents[c]
        infl = self._inflight[self._pipe_of[c]]
        ready: List[int] = []
        for idx in range(rids.size):
            rid = int(rids[idx])
            cnt = buf.get(rid, 0) + 1
            if cnt < need:
                buf[rid] = cnt
                if cnt > 1:              # absorbed into the one entry
                    infl[rid] -= 1
            else:                        # last parent: release to queue
                del buf[rid]
                infl[rid] -= 1
                ready.append(idx)
        if ready:
            sel = np.array(ready)
            self._arrive_batch_rid(c, arrs[sel], rids[sel])

    def _dag_cancel(self, s: int, rids) -> None:        # type: ignore[override]
        p = self._pipe_of[s]
        infl = self._inflight[p]
        dead = self._dead[p]
        purge = set()
        for rid in rids:
            rid = int(rid)
            n = infl[rid] - 1
            if n:                        # copies still out there
                infl[rid] = n
                dead.add(rid)
                purge.add(rid)
            else:
                del infl[rid]
        if not purge:
            return
        for j in self._stages_of[p]:
            if j == s:
                continue
            buf = self._join_buf[j]
            if buf:
                for rid in purge.intersection(buf):
                    del buf[rid]
                    self._dec_token(p, rid)
            q = self.queues[j]
            if len(q):
                removed = q.discard_rids(purge)
                if removed.size:
                    for r in removed:
                        self._dec_token(p, int(r))
                    self._bump(j)
                    self._try_dispatch(j)

    def _try_dispatch(self, s: int) -> None:
        q = self.queues[s]
        now = self.now
        thr = self._drop_thr_s[s]
        dag = self._dag_route[s]
        if now - q.min_arr > thr:
            if dag:
                rids_dropped = q.drop_expired_rid(now, thr)
                if rids_dropped.size:
                    self.metrics_by_pipe[self._pipe_of[s]].dropped += \
                        rids_dropped.size
                    self._bump(s)
                    self._dag_cancel(s, rids_dropped)
            else:
                k_dropped = q.drop_expired(now, thr)
                if k_dropped:
                    self.metrics_by_pipe[self._pipe_of[s]].dropped += \
                        k_dropped
                    self._bump(s)
        nq = q.n - q.head
        if not nq:
            return
        batch_sz = self.configs[s].batch
        free = self.free_at[s]
        limit = now + _EPS
        tab = self._lat_tab[s]
        tab_n = len(tab)
        evq = self._evq
        gen = self._gen
        while nq:
            if nq < batch_sz:
                deadline = q.head_enter() + self._wait_bounds()[s]
                if now < deadline - _EPS:
                    self._schedule_timeout(s, deadline)
                    return
                k = nq
            else:
                k = batch_sz
            nf = len(free)
            if nf == 0:
                self._schedule_wake(s, q.head_arrival() + thr)
                return
            if nf > _NP_SCAN_MIN:
                arr = np.asarray(free)
                avail = (arr <= limit).nonzero()[0]
                n_avail = avail.size
                if n_avail == 0:
                    self._schedule_wake(s, float(arr.min()))
                    return
                rep = int(avail[self.rr[s] % n_avail])
            else:
                avail = [i for i, t in enumerate(free) if t <= limit]
                n_avail = len(avail)
                if n_avail == 0:
                    self._schedule_wake(s, min(free))
                    return
                rep = avail[self.rr[s] % n_avail]
            if dag:
                arrs, rids = q.pop_batch_rid(k)
            else:
                arrs = q.pop_batch(k)
            nq -= k
            self.rr[s] += 1
            done_t = now + (tab[k] if k < tab_n
                            else self._stage_latency(s, k))
            free[rep] = done_t
            self.in_service += k
            evq.push(done_t, _EV_DONE,
                     (s, arrs, rids) if dag else (s, arrs))
            gen[s] += 1                  # inlined _bump (lazy cancel)
            self._timeout_at[s] = _INF

    def _handle_ev(self, kind: int, payload) -> None:
        if kind == _EV_DONE:
            s = payload[0]
            if self._dag_route[s]:           # 3-tuple payload with rids
                _, arrs, rids = payload
                self.in_service -= arrs.size
                self._done_dag(s, arrs, rids)
            else:
                _, arrs = payload
                self.in_service -= arrs.size
                nxt = self._next[s]
                if nxt >= 0:
                    self._arrive_batch(nxt, arrs)
                else:
                    m = self.metrics_by_pipe[self._pipe_of[s]]
                    m.completed += arrs.size
                    m._lat.extend(self.now - arrs)   # vectorized per-batch
            q = self.queues[s]
            if q.n > q.head:
                self._try_dispatch(s)
        elif kind == _EV_TIMEOUT:
            s, gen = payload
            if self._timeout_at[s] <= self.now + _EPS:
                self._timeout_at[s] = _INF
            if gen == self._gen[s]:
                q = self.queues[s]
                if q.n > q.head:
                    self._try_dispatch(s)
        elif kind == _EV_WAKE:
            s = payload
            if self._wake_at[s] <= self.now + _EPS:
                self._wake_at[s] = _INF
            q = self.queues[s]
            if q.n > q.head:
                self._try_dispatch(s)
        else:                            # _EV_APPLY
            p, gen = payload
            if gen == self._pending_gen[p] and \
                    self._pending_cfg[p] is not None:
                cfg = self._pending_cfg[p]
                self._pending_cfg[p] = None
                self._apply_pipeline_config(p, cfg)

    # -- lazy bulk arrival delivery ----------------------------------------
    #
    # Injected arrivals only ever target a pipeline's first stage, and an
    # arrival that merely appends to its stage queue commutes with every
    # event touching *other* stages.  So instead of merging arrivals into
    # the global event order (the heapq core's loop), each pipeline's
    # buffer is delivered lazily: `_first_trigger` classifies the first
    # pending arrival that the heapq core would do anything for beyond a
    # queue append; those *triggers* are sequenced against the event heap
    # (a (time, pipeline, version) heap with lazy invalidation), while the
    # pure appends before them land as one slice op per stage — `_sync` —
    # only when an event or trigger actually touches that stage.
    def _first_trigger(self, s: int, buf: np.ndarray, i: int, n: int) -> int:
        """Absolute index in ``[i, n]`` of the first pending arrival in
        ``buf[i:n]`` (one injection stage's buffer, ascending) needing the
        exact per-event path — fill the forming batch (dispatch), find no
        live timeout (arm one), tie with the armed wake's replica-free
        time, or cross the §4.5 drop threshold ``min_arr + thr``; ``n`` if
        every pending arrival is a pure append."""
        q = self.queues[s]
        wake = self._wake_at[s]
        if wake != _INF:
            # no replica frees before the wake fires; arrivals only queue
            # (dispatch attempts are provable no-ops).  Near the wake
            # instant a replica may tie with an arrival, so route that
            # boundary through the exact path.
            k = i + int(buf[i:n].searchsorted(wake - 1e-9, side="left"))
        elif self._timeout_at[s] != _INF:
            # forming batch with a live timeout: appends are pure while
            # the queue stays strictly below the batch size
            k = i + self._batch_of[s] - 1 - (q.n - q.head)
            if k < i:
                k = i
            elif k > n:
                k = n
        else:
            k = i                        # next arrival arms/dispatches
        if k > i:
            # §4.5 drop trigger: the heapq core consults
            # now - min_arr > thr at each arrival, with now there equal to
            # max(run-entry clock, arrival time) and min_arr the
            # conservative bound over queued + pending arrivals
            m_eff = q.min_arr
            t0 = buf[i]
            if t0 < m_eff:
                m_eff = t0
            t_trig = m_eff + self._drop_thr_s[s]
            if self._now0 > t_trig:
                k = i
            elif buf[k - 1] > t_trig:    # only search when drops imminent
                kd = i + int(buf[i:n].searchsorted(t_trig, side="right"))
                if kd < k:
                    k = kd
        return k

    def _recompute_trigger(self, p: int) -> None:
        """Reclassify pipeline ``p``'s next trigger after anything touched
        its injection stage's state (dispatch, drop, timeout/wake marker,
        config apply) and push the fresh entry; the version bump
        invalidates every stale heap entry for ``p``."""
        ver = self._trig_ver[p] + 1
        self._trig_ver[p] = ver
        i, n = self._pi[p], self._pn[p]
        if i >= n:
            self._next_k[p] = n
            return
        buf = self._pt[p]
        k = self._first_trigger(self._first[p], buf, i, n)
        self._next_k[p] = k
        if k < n:
            heapq.heappush(self._trigh, (buf[k], p, ver))

    def _sync(self, p: int, tau: float) -> int:
        """Deliver pipeline ``p``'s pending pure-append arrivals with
        ``t <= tau`` as one queue-column slice op.  Appends never reach
        past ``_next_k`` (the next trigger), so no classification can be
        violated.  Returns the number delivered."""
        i = self._pi[p]
        lim_k = self._next_k[p]
        if i >= lim_k:
            return 0
        buf = self._pt[p]
        if buf[i] > tau:
            return 0
        j = i + int(buf[i:lim_k].searchsorted(tau, side="right"))
        vals = buf[i:j]
        now0 = self._now0
        # stage-enter is the arrival's own instant, except stale
        # (past-time) injections which enter at the run-entry clock
        enter = np.maximum(vals, now0) if now0 > vals[0] else vals
        q = self.queues[self._first[p]]
        if self._dag_pipe[p]:
            rid0 = self._rid_next[p]
            k = vals.size
            infl = self._inflight[p]
            for rid in range(rid0, rid0 + k):
                infl[rid] = 1
            self._rid_next[p] = rid0 + k
            q.push_bulk(vals, enter, np.arange(rid0, rid0 + k,
                                               dtype=np.int64))
        else:
            q.push_bulk(vals, enter)
        d = q.n - q.head
        if d > self.peak_queue_depth:
            self.peak_queue_depth = d
        self._pi[p] = j
        return j - i

    def run_until(self, t_end: float) -> None:
        P = self.n_pipelines
        for p in range(P):
            if self._p_unsorted[p]:
                self._pt[p][self._pi[p]:self._pn[p]].sort(kind="stable")
                self._p_unsorted[p] = False
        self._now0 = self.now
        trigh: List[Tuple[float, int, int]] = []
        self._trigh = trigh
        for p in range(P):
            self._recompute_trigger(p)
        evq = self._evq
        heap = evq._heap
        trig_ver = self._trig_ver
        first = self._first
        inj_pipe = self._inj_pipe
        handle = self._handle_ev
        n_ev = 0
        while True:
            while trigh and trigh[0][2] != trig_ver[trigh[0][1]]:
                heapq.heappop(trigh)
            t_trig = trigh[0][0] if trigh else _INF
            t_head = heap[0][0] if heap else _INF
            # arrivals win ties against events, exactly like the heapq core
            if t_trig <= t_head and t_trig <= t_end:
                t, p, _ = heapq.heappop(trigh)
                n_ev += self._sync(p, t) + 1
                tf = float(t)
                if tf > self.now:
                    self.now = tf
                self._pi[p] = self._next_k[p] + 1
                self._arrive_one(first[p], tf)
                self._recompute_trigger(p)
                continue
            if t_head <= t_end:
                t, kinds, pays = evq.pop_batch()
                if t > self.now:
                    self.now = t
                for kd, pay in zip(kinds, pays):
                    if kd == _EV_DONE or kd == _EV_TIMEOUT:
                        s = pay[0]
                    elif kd == _EV_WAKE:
                        s = pay
                    else:
                        s = first[pay[0]]
                    p = inj_pipe[s]
                    if p >= 0:
                        # the event touches an injection stage: its pending
                        # appends up to t must land first, and its trigger
                        # classification is stale afterwards
                        n_ev += self._sync(p, t)
                        handle(kd, pay)
                        self._recompute_trigger(p)
                    else:
                        handle(kd, pay)
                n_ev += len(kinds)
                continue
            break
        for p in range(P):
            n_ev += self._sync(p, t_end)
            i = self._pi[p]
            if i > 4096 and 2 * i >= self._pn[p]:
                n = self._pn[p]
                live = n - i
                self._pt[p][:live] = self._pt[p][i:n].copy()
                self._pi[p] = 0
                self._pn[p] = live
        self.events_processed += n_ev
        if t_end > self.now:             # never rewind the event clock
            self.now = t_end


# ---------------------------------------------------------------------------
# service-round event core
#
# The struct core above still sequences every derived event (done / timeout /
# wake / apply) through ONE global heap and re-classifies a pipeline's
# arrival trigger on every event that touches its injection stage — at
# BENCH_scale that global interleaving is pure overhead, because pipelines
# sharing a cluster do not interact between control-plane actions: queues,
# replica fleets, generation counters, metrics and DAG state are all
# per-pipeline, and the only cross-pipeline couplings are the replica
# ledger (consulted at reconfigure time, outside run_until) and the
# ``peak_serving_cores`` witness (touched only by §5.3 apply events).
#
# The round core exploits that independence: each pipeline keeps its own
# event columns, and ``run_until`` retires one pipeline's *entire* event
# frontier — service starts, completions, timeout fires, wake scans, bulk
# arrival appends — in one round before moving to the next, instead of
# interleaving single events across pipelines.  Within a pipeline the event
# order is exactly the struct core's (same (t, seq) discipline, same
# tie-breaks), so every per-pipeline stream is bit-identical by
# construction; the order-coupled remainder — the relative order of §5.3
# apply events across pipelines, which is what the serving-peak witness
# observes — is restored exactly by logging each apply's ledger settlement
# and replaying the log in global (t, seq) order afterwards.  Chains
# additionally run a fully inlined per-pipeline loop (locals instead of
# attribute chases, dispatch/arrive/sync inlined); DAG pipelines and any
# other order-coupled path (joins, drop propagation, deferred applies)
# take the exact scalar struct path per event, still inside their own
# round.  The equivalence suites pin completed / dropped / latency
# streams / events_processed / reconfig_log / peaks bit-identical to BOTH
# existing cores.
# ---------------------------------------------------------------------------


class _RoutedEventQueue:
    """``_EventColumns``-compatible push target that files each derived
    event into the owning pipeline's private round heap.  Control-plane
    code (reconfigure, set_lam_est, deferred applies) pushes through the
    shared ``_push``/``_try_dispatch`` paths without knowing which core
    runs underneath; the shared ``seq`` counter keeps same-timestamp
    events in push order exactly like ``_EventColumns``."""

    __slots__ = ("_sim",)

    def __init__(self, sim):
        self._sim = sim

    def push(self, t: float, kind: int, payload) -> None:
        sim = self._sim
        if kind == _EV_WAKE:
            p = sim._pipe_of[payload]
        elif kind == _EV_APPLY:
            p = payload[0]
        else:                            # done / timeout payloads lead with s
            p = sim._pipe_of[payload[0]]
        heapq.heappush(sim._pq[p], (t, next(sim._rseq), kind, payload))


class _RoundCore(_StructCore):
    """Mixin implementing the service-round event core (see the section
    comment above).  Same external contract and limitations as
    ``_StructCore`` — aggregate metrics bit-identical to both other cores,
    no per-request objects — at a higher events/sec: pipelines are retired
    in independent rounds instead of through one globally interleaved
    heap."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        # one event heap per pipeline, ordered by (t, seq) with a shared
        # seq counter — the struct core's global order restricted to the
        # pipeline, which is all any per-pipeline state can observe
        self._pq: List[List[Tuple[float, int, int, object]]] = [
            [] for _ in range(self.n_pipelines)]
        self._rseq = itertools.count()
        self._evq = _RoutedEventQueue(self)
        # §5.3 apply events are the one cross-pipeline coupling inside a
        # run (the serving-peak witness sums every pipeline's serving cost
        # at each settlement): while a round runs, ledger settlements are
        # logged instead of sampled, then replayed in global (t, seq)
        # order against the run-entry snapshot
        self._defer_peak = False
        self._peak_log: List[tuple] = []
        self._apply_seq = 0
        self._apply_p = 0

    def _note_serving_peak(self) -> None:
        if self._defer_peak:
            p = self._apply_p
            vec = None if self._serving_vec is None else self._serving_vec[p]
            self._peak_log.append((self.now, self._apply_seq, p,
                                   self._serving_cost[p], vec))
            return
        super()._note_serving_peak()

    def _replay_serving_peaks(self, snap: List[float],
                              vsnap: Optional[List[tuple]]) -> None:
        """Replay the round's deferred ledger settlements in global
        (t, seq) order against the run-entry serving snapshot — the exact
        sequence of ``sum(_serving_cost)`` values the struct core samples
        at each apply event."""
        log = self._peak_log
        log.sort(key=lambda e: (e[0], e[1]))
        peak = self.peak_serving_cores
        for _t, _seq, p, cost, vec in log:
            snap[p] = cost
            total = sum(snap)
            if total > peak:
                peak = total
            if vec is not None:
                vsnap[p] = vec
                self.peak_serving_by_class = tuple(
                    max(pk, sum(v[c] for v in vsnap))
                    for c, pk in enumerate(self.peak_serving_by_class))
        self.peak_serving_cores = peak
        log.clear()

    def run_until(self, t_end: float) -> None:
        P = self.n_pipelines
        for p in range(P):
            if self._p_unsorted[p]:
                self._pt[p][self._pi[p]:self._pn[p]].sort(kind="stable")
                self._p_unsorted[p] = False
        now0 = self.now
        self._now0 = now0
        snap = list(self._serving_cost)
        vsnap = None if self._serving_vec is None else list(self._serving_vec)
        self._defer_peak = True
        n_ev = 0
        try:
            for p in range(P):
                self.now = now0
                if self._dag_pipe[p]:
                    n_ev += self._run_pipe_generic(p, t_end)
                else:
                    n_ev += self._run_pipe_chain(p, t_end)
        finally:
            self._defer_peak = False
        if self._peak_log:
            self._replay_serving_peaks(snap, vsnap)
        self.events_processed += n_ev
        self.now = t_end if t_end > now0 else now0

    def _compact_buf(self, p: int) -> None:
        i = self._pi[p]
        if i > 4096 and 2 * i >= self._pn[p]:
            n = self._pn[p]
            live = n - i
            self._pt[p][:live] = self._pt[p][i:n].copy()
            self._pi[p] = 0
            self._pn[p] = live

    def _run_pipe_generic(self, p: int, t_end: float) -> int:
        """One pipeline's round through the exact scalar struct paths —
        the order-coupled fallback (DAG joins / drop propagation, and any
        topology the inlined chain loop doesn't cover)."""
        pq = self._pq[p]
        first = self._first[p]
        buf = self._pt[p]
        handle = self._handle_ev
        pop = heapq.heappop
        i, n = self._pi[p], self._pn[p]
        k = self._first_trigger(first, buf, i, n) if i < n else n
        self._next_k[p] = k
        n_ev = 0
        while True:
            t_trig = buf[k] if k < n else _INF
            t_head = pq[0][0] if pq else _INF
            # arrivals win ties against events, exactly like both cores
            if t_trig <= t_head and t_trig <= t_end:
                tf = float(t_trig)
                n_ev += self._sync(p, tf) + 1
                if tf > self.now:
                    self.now = tf
                self._pi[p] = k + 1
                self._arrive_one(first, tf)
                i = self._pi[p]
                k = self._first_trigger(first, buf, i, n) if i < n else n
                self._next_k[p] = k
                continue
            if t_head > t_end:
                break
            if t_head > self.now:
                self.now = t_head
            t0, sq, kind, pay = pop(pq)
            batch = [(sq, kind, pay)]
            while pq and pq[0][0] == t0:
                _t, sq2, kd2, py2 = pop(pq)
                batch.append((sq2, kd2, py2))
            for sq, kind, pay in batch:
                if kind == _EV_DONE or kind == _EV_TIMEOUT:
                    s = pay[0]
                elif kind == _EV_WAKE:
                    s = pay
                else:
                    s = first            # apply: settles this pipeline
                if s == first:
                    n_ev += self._sync(p, t0)
                    if kind == _EV_APPLY:
                        self._apply_seq = sq
                        self._apply_p = p
                    handle(kind, pay)
                    i = self._pi[p]
                    k = self._first_trigger(first, buf, i, n) \
                        if i < n else n
                    self._next_k[p] = k
                else:
                    handle(kind, pay)
            n_ev += len(batch)
        n_ev += self._sync(p, t_end)
        self._compact_buf(p)
        return n_ev

    def _run_pipe_chain(self, p: int, t_end: float) -> int:
        """One chain pipeline's round, fully inlined: the struct core's
        _first_trigger / _sync / _arrive_one / _handle_ev / _try_dispatch
        bodies with per-stage state in locals — instruction-for-
        instruction the same state transitions (the equivalence and golden
        suites pin it), minus the per-event attribute chases and method
        dispatch."""
        pq = self._pq[p]
        base = self._first[p]
        buf = self._pt[p]
        queues = self.queues
        q0 = queues[base]
        gen = self._gen
        timeout_at = self._timeout_at
        wake_at = self._wake_at
        free_at = self.free_at
        rr = self.rr
        nxt = self._next
        thr_g = self._drop_thr_s
        lat_tab = self._lat_tab
        batch_of = self._batch_of
        m = self.metrics_by_pipe[p]
        lat_buf = m._lat
        rseq = self._rseq
        push = heapq.heappush
        pop = heapq.heappop
        now0 = self._now0
        thr0 = thr_g[base]
        insvc = 0
        peak_qd = self.peak_queue_depth
        n_ev = 0

        def dispatch(s: int, now: float) -> None:
            # struct _try_dispatch, chain path, with hot state in closure
            nonlocal insvc
            q = queues[s]
            thr = thr_g[s]
            if now - q.min_arr > thr:
                kd = q.drop_expired(now, thr)
                if kd:
                    m.dropped += kd
                    gen[s] += 1
                    timeout_at[s] = _INF
            nq = q.n - q.head
            if not nq:
                return
            batch_sz = batch_of[s]
            free = free_at[s]
            limit = now + _EPS
            tab = lat_tab[s]
            tab_n = len(tab)
            while nq:
                if nq < batch_sz:
                    wb = self._wb
                    if wb is None:
                        wb = self._wait_bounds()
                    deadline = float(q._enter[q.head] + wb[s])
                    if now < deadline - _EPS:
                        if deadline < timeout_at[s] - _EPS:   # _schedule_timeout
                            timeout_at[s] = deadline
                            push(pq, (deadline, next(rseq), _EV_TIMEOUT,
                                      (s, gen[s])))
                        return
                    k = nq
                else:
                    k = batch_sz
                # armed-wake short-circuit: the wake marker was set to the
                # fleet's min free time, and free times only move when a
                # service starts, which needs a free replica — so strictly
                # before the marker no replica can be available and the
                # rearm attempt is provably the no-op the struct core
                # recomputes from scratch
                w = wake_at[s]
                if w != _INF and now < w - _EPS and free:
                    return
                nf = len(free)
                if nf == 0:
                    t = float(q._arr[q.head] + thr)
                    if t <= now + _EPS:                       # _schedule_wake
                        t = now + 1e-9
                    if t < wake_at[s] - _EPS:
                        wake_at[s] = t
                        push(pq, (t, next(rseq), _EV_WAKE, s))
                    return
                if nf > _NP_SCAN_MIN:
                    arr = np.asarray(free)
                    avail = (arr <= limit).nonzero()[0]
                    n_avail = avail.size
                    if n_avail == 0:
                        t = float(arr.min())
                        if t <= now + _EPS:
                            t = now + 1e-9
                        if t < wake_at[s] - _EPS:
                            wake_at[s] = t
                            push(pq, (t, next(rseq), _EV_WAKE, s))
                        return
                    rep = int(avail[rr[s] % n_avail])
                else:
                    avail = [j for j, tv in enumerate(free) if tv <= limit]
                    n_avail = len(avail)
                    if n_avail == 0:
                        t = float(min(free))
                        if t <= now + _EPS:
                            t = now + 1e-9
                        if t < wake_at[s] - _EPS:
                            wake_at[s] = t
                            push(pq, (t, next(rseq), _EV_WAKE, s))
                        return
                    rep = avail[rr[s] % n_avail]
                asc = q.fifo_ok
                arrs = q.pop_batch(k)
                nq -= k
                rr[s] += 1
                done_t = now + (tab[k] if k < tab_n
                                else self._stage_latency(s, k))
                free[rep] = done_t
                insvc += k
                push(pq, (done_t, next(rseq), _EV_DONE, (s, arrs, asc)))
                gen[s] += 1              # inlined _bump (lazy cancel)
                timeout_at[s] = _INF

        # round-scoped classification caches: buf[i0:n] is immutable and
        # ascending for the whole round, so the absolute insertion point of
        # a given wake time / drop trigger is computed once per distinct
        # value instead of once per event (struct re-searches every time)
        i0 = self._pi[p]
        pi = i0
        n = self._pn[p]
        cw_val = cd_val = None
        cw_pos = cd_pos = 0

        def classify(i: int) -> int:
            # struct _first_trigger for the injection stage
            nonlocal cw_val, cw_pos, cd_val, cd_pos
            w = wake_at[base]
            if w != _INF:
                if w != cw_val:
                    cw_val = w
                    cw_pos = i0 + int(
                        buf[i0:n].searchsorted(w - 1e-9, side="left"))
                k = cw_pos if cw_pos > i else i
            elif timeout_at[base] != _INF:
                k = i + batch_of[base] - 1 - (q0.n - q0.head)
                if k < i:
                    k = i
                elif k > n:
                    k = n
            else:
                k = i
            if k > i:
                m_eff = q0.min_arr
                t0v = buf.item(i)
                if t0v < m_eff:
                    m_eff = t0v
                t_trig = m_eff + thr0
                if now0 > t_trig:
                    k = i
                elif buf.item(k - 1) > t_trig:
                    if t_trig != cd_val:
                        cd_val = t_trig
                        cd_pos = i0 + int(
                            buf[i0:n].searchsorted(t_trig, side="right"))
                    kd = cd_pos if cd_pos > i else i
                    if kd < k:
                        k = kd
            return k

        def deliver(j: int) -> int:
            # struct _sync tail: hand buf[pi:j] to the injection queue
            nonlocal pi, peak_qd
            cnt = j - pi
            vals = buf[pi:j]
            enter = np.maximum(vals, now0) if now0 > vals[0] else vals
            q0.push_bulk(vals, enter)
            d = q0.n - q0.head
            if d > peak_qd:
                peak_qd = d
            pi = j
            return cnt

        k = classify(pi) if pi < n else n
        now = self.now
        while True:
            t_trig = buf.item(k) if k < n else _INF
            t_head = pq[0][0] if pq else _INF
            if t_trig <= t_head and t_trig <= t_end:
                tf = t_trig
                # everything in [pi, k) is <= buf[k] by sort order, so the
                # pre-trigger sync is one unconditional block delivery
                if pi < k:
                    n_ev += deliver(k)
                n_ev += 1
                if tf > now:
                    now = tf
                pi = k + 1
                q0.push_scalar(tf, now)                       # _arrive_one
                d = q0.n - q0.head
                if d > peak_qd:
                    peak_qd = d
                if (d >= batch_of[base] or timeout_at[base] == _INF
                        or now - q0.min_arr > thr0):
                    dispatch(base, now)
                k = classify(pi) if pi < n else n
                continue
            if t_head > t_end:
                break
            if t_head > now:
                now = t_head
            t0, sq, kind, pay = pop(pq)
            batch = [(sq, kind, pay)]
            while pq and pq[0][0] == t0:
                _t, sq2, kd2, py2 = pop(pq)
                batch.append((sq2, kd2, py2))
            for sq, kind, pay in batch:
                if kind == _EV_DONE:
                    s = pay[0]
                    if s == base:
                        if pi < k and buf[pi] <= t0:          # _sync
                            j = pi + int(
                                buf[pi:k].searchsorted(t0, side="right"))
                            n_ev += deliver(j)
                    arrs = pay[1]
                    ksz = arrs.size
                    insvc -= ksz
                    nx = nxt[s]
                    if nx >= 0:
                        q = queues[nx]                        # _arrive_batch
                        q.push_bulk(arrs, now, None,
                                    len(pay) == 3 and pay[2])
                        d = q.n - q.head
                        if d > peak_qd:
                            peak_qd = d
                        if (d >= batch_of[nx] or timeout_at[nx] == _INF
                                or now - q.min_arr > thr_g[nx]):
                            dispatch(nx, now)
                    else:
                        m.completed += ksz
                        lat_buf.extend(now - arrs)
                    q = queues[s]
                    if q.n > q.head:
                        dispatch(s, now)
                    if s == base:
                        k = classify(pi) if pi < n else n
                elif kind == _EV_TIMEOUT:
                    s, g = pay
                    if s == base:
                        if pi < k and buf[pi] <= t0:
                            j = pi + int(
                                buf[pi:k].searchsorted(t0, side="right"))
                            n_ev += deliver(j)
                    if timeout_at[s] <= now + _EPS:
                        timeout_at[s] = _INF
                    if g == gen[s]:
                        q = queues[s]
                        if q.n > q.head:
                            dispatch(s, now)
                    if s == base:
                        k = classify(pi) if pi < n else n
                elif kind == _EV_WAKE:
                    s = pay
                    if s == base:
                        if pi < k and buf[pi] <= t0:
                            j = pi + int(
                                buf[pi:k].searchsorted(t0, side="right"))
                            n_ev += deliver(j)
                    if wake_at[s] <= now + _EPS:
                        wake_at[s] = _INF
                    q = queues[s]
                    if q.n > q.head:
                        dispatch(s, now)
                    if s == base:
                        k = classify(pi) if pi < n else n
                else:                    # _EV_APPLY: order-coupled, exact path
                    if pi < k and buf[pi] <= t0:
                        j = pi + int(
                            buf[pi:k].searchsorted(t0, side="right"))
                        n_ev += deliver(j)
                    self.now = now
                    self._pi[p] = pi
                    self._apply_seq = sq
                    self._apply_p = p
                    self._handle_ev(kind, pay)
                    k = classify(pi) if pi < n else n
            n_ev += len(batch)
        if pi < n and buf[pi] <= t_end:                       # final _sync
            lim = k if k < n else n
            if pi < lim:
                j = pi + int(buf[pi:lim].searchsorted(t_end, side="right"))
                if j > pi:
                    n_ev += deliver(j)
        self.now = now
        self._pi[p] = pi
        self._next_k[p] = k
        self.in_service += insvc
        if peak_qd > self.peak_queue_depth:
            self.peak_queue_depth = peak_qd
        self._compact_buf(p)
        return n_ev


class PipelineSimulator(ClusterSimulator):
    """The N=1 special case: one pipeline, unbounded core budget, the
    original single-pipeline API.  Shares every event-machinery code path
    with ``ClusterSimulator`` — cluster equivalence at N=1 is structural,
    and the equivalence tests pin it."""

    def __init__(self, pipe: PipelineModel, config: PipelineConfig, **kw):
        super().__init__(single(pipe), ClusterConfig((config,)), **kw)
        self.pipe = pipe

    @property
    def metrics(self) -> SimMetrics:
        return self.metrics_by_pipe[0]

    @property
    def sla_p(self) -> float:
        return self.sla_of[0]

    @property
    def lam_est(self) -> float:
        return self._lam_of[0]

    @lam_est.setter
    def lam_est(self, v: float) -> None:
        self.set_lam_est(0, v)

    @property
    def current_config(self) -> PipelineConfig:
        """The configuration the simulator is committed to (the pending
        transition target while an adaptation window is in flight; see
        ``pipeline_config`` vs ``serving_config``)."""
        return self.pipeline_config(0)

    def reconfigure(self, config: PipelineConfig) -> None:  # type: ignore[override]
        self.reconfigure_pipeline(0, config)


class StructClusterSimulator(_StructCore, ClusterSimulator):
    """``ClusterSimulator`` on the structured-array event core."""


class StructPipelineSimulator(_StructCore, PipelineSimulator):
    """``PipelineSimulator`` on the structured-array event core."""


class RoundClusterSimulator(_RoundCore, ClusterSimulator):
    """``ClusterSimulator`` on the service-round event core."""


class RoundPipelineSimulator(_RoundCore, PipelineSimulator):
    """``PipelineSimulator`` on the service-round event core."""


EVENT_CORES = ("heap", "struct", "round")


def make_cluster_simulator(cluster, config, event_core: str = "heap", **kw):
    """Build a cluster simulator on the chosen event core.

    ``"heap"`` is the per-event reference core (full per-request
    bookkeeping: timelines, pools, injected-object writeback); ``"struct"``
    is the structured-array bulk core — bit-identical aggregate results,
    several times the throughput at production scale; ``"round"`` is the
    service-round core — bit-identical to both, retiring each pipeline's
    event frontier in independent rounds for another multiple on top (see
    ``benchmarks/bench_scale.py``)."""
    if event_core == "heap":
        return ClusterSimulator(cluster, config, **kw)
    if event_core == "struct":
        return StructClusterSimulator(cluster, config, **kw)
    if event_core == "round":
        return RoundClusterSimulator(cluster, config, **kw)
    raise ValueError(f"unknown event core {event_core!r}; "
                     f"expected one of {EVENT_CORES}")
