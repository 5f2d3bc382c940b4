"""Request/response records flowing through an inference pipeline."""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional

_ids = itertools.count()


@dataclasses.dataclass(slots=True)
class Request:
    arrival: float                       # seconds, pipeline ingress
    payload: Any = None                  # tokens (np.ndarray) or None (synthetic)
    req_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    sla: Optional[float] = None          # end-to-end latency SLA (s)
    # bookkeeping filled in as the request flows
    stage_enter: Dict[int, float] = dataclasses.field(default_factory=dict)
    stage_exit: Dict[int, float] = dataclasses.field(default_factory=dict)
    dropped_at: Optional[int] = None
    done: float = float("nan")
    # per-pipeline request id stamped by the simulator at first-stage
    # entry of a DAG pipeline (join matching + drop propagation); -1 on
    # chain pipelines, which never need it
    rid: int = -1

    @property
    def latency(self) -> float:
        return self.done - self.arrival

    @property
    def dropped(self) -> bool:
        return self.dropped_at is not None

    def reset(self, arrival: float, sla: Optional[float] = None) -> "Request":
        """Re-initialize for reuse out of a ``RequestPool`` (fresh id)."""
        self.arrival = arrival
        self.payload = None
        self.req_id = next(_ids)
        self.sla = sla
        self.stage_enter.clear()
        self.stage_exit.clear()
        self.dropped_at = None
        self.done = float("nan")
        self.rid = -1
        return self


class RequestPool:
    """Free-list of ``Request`` objects for allocation-heavy replay loops.

    The simulator hot path creates no requests itself, but its drivers
    (adapter traces, benchmarks) allocate one per arrival; with a pool the
    simulator releases each request back at its terminal event (completion
    or drop) so steady-state replay reuses a small working set instead of
    churning the allocator.  Only safe when the driver does not hold
    references to injected requests past their completion.
    """

    __slots__ = ("_free", "allocated", "reused")

    def __init__(self):
        self._free: List[Request] = []
        self.allocated = 0
        self.reused = 0

    def acquire(self, arrival: float, sla: Optional[float] = None) -> Request:
        if self._free:
            self.reused += 1
            return self._free.pop().reset(arrival, sla)
        self.allocated += 1
        return Request(arrival=arrival, sla=sla)

    def acquire_many(self, arrivals, sla: Optional[float] = None
                     ) -> List[Request]:
        """Bulk ``acquire``: recycle up to ``len(arrivals)`` pooled
        requests in one slice, allocate the rest.  Requests come back in
        arrival order (ids are stamped in that order, as sequential
        ``acquire`` calls would)."""
        free = self._free
        k = len(arrivals)
        reuse = min(len(free), k)
        out: List[Request] = []
        if reuse:
            self.reused += reuse
            recycled = free[-reuse:]
            del free[-reuse:]
            out.extend(r.reset(t, sla)
                       for r, t in zip(recycled, arrivals))
        if reuse < k:
            self.allocated += k - reuse
            out.extend(Request(arrival=t, sla=sla)
                       for t in arrivals[reuse:])
        return out

    def release(self, req: Request) -> None:
        self._free.append(req)

    def release_many(self, reqs) -> None:
        self._free.extend(reqs)


@dataclasses.dataclass
class BatchRecord:
    stage: int
    size: int
    formed_at: float
    started: float
    finished: float
    replica: int
    variant: str
