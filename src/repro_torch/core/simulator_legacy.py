"""Reference tick-based simulator — FROZEN, not part of the serving path.

This is the seed implementation of the discrete-event pipeline simulator,
kept verbatim for two purposes only:

* the old-vs-new equivalence harness (``tests/test_simulator_equivalence``)
  proving the event-driven core in ``simulator.py`` produces identical
  completed/dropped counts on deterministic traces, and
* the benchmark baseline in ``benchmarks/bench_simulator.py`` that tracks
  the speedup of the event-driven core over this tick flood.

Its flaw — and why it was replaced — is ``run_until``: it pushes a "tick"
event per stage every ``tick`` seconds of simulated time so partially
filled batches can time out, which schedules O(horizon / tick x stages)
no-op events before a single request arrives.  Do not import it from
production code.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import List, Tuple

from repro_torch.core.pipeline import PipelineConfig, PipelineModel, StageConfig
from repro_torch.serving.request import Request


@dataclasses.dataclass
class LegacySimMetrics:
    latencies: List[float] = dataclasses.field(default_factory=list)
    completed: int = 0
    dropped: int = 0
    arrived: int = 0

    def sla_violations(self, sla: float) -> float:
        if self.arrived == 0:
            return 0.0
        late = sum(1 for l in self.latencies if l > sla)
        return (late + self.dropped) / self.arrived


class LegacyTickSimulator:
    def __init__(self, pipe: PipelineModel, config: PipelineConfig,
                 drop_factor: float = 2.0, max_wait: float = 0.5,
                 seed: int = 0, variant_switch_delay: float = 0.0,
                 scale_up_delay: float = 0.0):
        self.pipe = pipe
        self.n_stages = len(pipe.stages)
        self.configs: List[StageConfig] = list(config.stages)
        self.drop_factor = drop_factor
        self.max_wait = max_wait
        self.variant_switch_delay = variant_switch_delay
        self.scale_up_delay = scale_up_delay
        self.queues: List[List[Request]] = [[] for _ in range(self.n_stages)]
        self.free_at: List[List[float]] = [
            [0.0] * sc.replicas for sc in self.configs]
        self.rr: List[int] = [0] * self.n_stages
        self.now = 0.0
        self.metrics = LegacySimMetrics()
        self._events: List[Tuple[float, int, str, object]] = []
        self._seq = itertools.count()
        self.lam_est = 10.0
        self.events_processed = 0

    def reconfigure(self, config: PipelineConfig) -> None:
        for s, sc in enumerate(config.stages):
            old = self.free_at[s]
            n = sc.replicas
            switched = sc.variant != self.configs[s].variant
            if switched and self.variant_switch_delay > 0:
                ready = self.now + self.variant_switch_delay
                old[:] = [max(t, ready) for t in old]
            if n >= len(old):
                start = self.now + (self.variant_switch_delay if switched
                                    else self.scale_up_delay)
                old.extend([start] * (n - len(old)))
            else:
                old.sort()
                del old[n:]
            self.configs[s] = sc

    def _push(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    def inject(self, req: Request) -> None:
        self.metrics.arrived += 1
        self._push(req.arrival, "arrive", (0, req))

    def _stage_latency(self, s: int, k: int) -> float:
        sc = self.configs[s]
        v = self.pipe.stages[s].variant(sc.variant)
        return float(v.latency(max(k, 1)))

    def _try_dispatch(self, s: int) -> None:
        q = self.queues[s]
        sc = self.configs[s]
        sla_p = self.pipe.sla
        kept = []
        for r in q:
            if (self.now - r.arrival) > self.drop_factor * sla_p:
                r.dropped_at = s
                r.done = self.now
                self.metrics.dropped += 1
            else:
                kept.append(r)
        q[:] = kept
        while q:
            free_idx = [i for i, t in enumerate(self.free_at[s])
                        if t <= self.now + 1e-12]
            if not free_idx:
                return
            full = len(q) >= sc.batch
            waited = self.now - q[0].stage_enter.get(s, q[0].arrival)
            timeout = waited >= self._wait_bound(sc.batch)
            if not (full or timeout):
                return
            k = min(sc.batch, len(q))
            batch, q[:] = q[:k], q[k:]
            rep = free_idx[self.rr[s] % len(free_idx)]
            self.rr[s] += 1
            lat = self._stage_latency(s, k)
            done_t = self.now + lat
            self.free_at[s][rep] = done_t
            self._push(done_t, "done", (s, batch))

    def _wait_bound(self, batch: int) -> float:
        return min(self.max_wait, (batch - 1) / max(self.lam_est, 1e-6)) \
            if batch > 1 else 0.0

    def _handle(self, kind: str, payload) -> None:
        if kind == "arrive":
            s, req = payload
            req.stage_enter[s] = self.now
            self.queues[s].append(req)
            self._try_dispatch(s)
        elif kind == "done":
            s, batch = payload
            for r in batch:
                r.stage_exit[s] = self.now
                if s + 1 < self.n_stages:
                    self._push(self.now, "arrive", (s + 1, r))
                else:
                    r.done = self.now
                    self.metrics.completed += 1
                    self.metrics.latencies.append(r.latency)
            self._try_dispatch(s)
        elif kind == "tick":
            s = payload
            self._try_dispatch(s)

    def run_until(self, t_end: float, tick: float = 0.05) -> None:
        t = self.now
        while t < t_end:
            t += tick
            for s in range(self.n_stages):
                self._push(t, "tick", s)
        while self._events and self._events[0][0] <= t_end:
            t, _, kind, payload = heapq.heappop(self._events)
            self.events_processed += 1
            self.now = max(self.now, t)
            self._handle(kind, payload)
        self.now = t_end
