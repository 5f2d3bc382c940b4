"""Centralized per-stage queue with batch formation (paper §3 "Pipeline
System": one central queue per stage, round-robin dispatch to replicas).

The queue forms a batch as soon as ``batch_size`` requests are waiting, or
when the oldest request has waited ``max_wait`` (so low load does not stall
forever — the paper's simulator uses the same arrival-driven bound that
yields the worst-case queueing delay q(b) = (b-1)/lambda of Eq. 7).
"""
from __future__ import annotations

import collections
from typing import Deque, List, Optional, Tuple

from repro_torch.serving.request import Request


class CentralQueue:
    def __init__(self, batch_size: int = 1, max_wait: float = 2.0):
        self.batch_size = batch_size
        self.max_wait = max_wait
        self._q: Deque[Request] = collections.deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, req: Request) -> None:
        self._q.append(req)

    def reconfigure(self, batch_size: int, max_wait: Optional[float] = None):
        self.batch_size = batch_size
        if max_wait is not None:
            self.max_wait = max_wait

    def oldest_wait(self, now: float) -> float:
        if not self._q:
            return 0.0
        return now - self._q[0].arrival

    def ready(self, now: float) -> bool:
        if len(self._q) >= self.batch_size:
            return True
        return bool(self._q) and self.oldest_wait(now) >= self.max_wait

    def pop_batch(self, now: float) -> List[Request]:
        n = min(self.batch_size, len(self._q))
        return [self._q.popleft() for _ in range(n)]

    def drain_expired(self, now: float, stage: int,
                      drop_factor: float = 2.0) -> List[Request]:
        """Paper §4.5: drop requests whose age already exceeds
        ``drop_factor x SLA`` (they cannot meet the SLA anyway)."""
        dropped = []
        keep: Deque[Request] = collections.deque()
        while self._q:
            r = self._q.popleft()
            if r.sla is not None and (now - r.arrival) > drop_factor * r.sla:
                r.dropped_at = stage
                r.done = now
                dropped.append(r)
            else:
                keep.append(r)
        self._q = keep
        return dropped
