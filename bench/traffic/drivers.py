"""Open- and closed-loop drivers: requests into the program's
``CentralQueue``, each batch it forms through ``serve``.

A driver takes the queue, a ``serve(tokens) -> (out, stage_lats)``, a
prompt maker and a clock with a sleep, so that a test can drive it with a
stub engine on a fake clock.  Each request's record holds its due time,
when it was pushed (how late the generator ran), when ``pop_batch`` took
it, when its last stage's tokens were back on the host, and whether its
batch failed.  A failed request has no done time and counts as over every
latency limit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import numpy as np

from repro_torch.serving.request import Request

# a wake-up computed from the queue's own clock arithmetic can round to
# just before the moment it waits for; sleep at least this long
MIN_SLEEP = 1e-4


@dataclasses.dataclass
class Rec:
    rid: int
    due: float
    pushed: float = math.nan
    popped: float = math.nan
    done: float = math.nan
    failed: bool = False
    batch: int = -1

    @property
    def latency(self) -> float:
        return math.inf if self.failed or math.isnan(self.done) else self.done - self.due


@dataclasses.dataclass
class Batch:
    rids: List[int]
    start: float
    end: float
    stage_lats: Optional[List[float]]


@dataclasses.dataclass
class Run:
    recs: List[Rec]
    batches: List[Batch]
    t0: float
    t_end: float              # the last completion


def _serve_batch(queue, serve, recs, batches, prompt, clock):
    now = clock()
    reqs = queue.pop_batch(now)
    ids = [r.payload for r in reqs]
    for i in ids:
        recs[i].popped = now
        recs[i].batch = len(batches)
    tokens = np.stack([prompt(i) for i in ids])
    try:
        _, lats = serve(tokens)
    except Exception as exc:          # noqa: BLE001  -- a failed batch is counted, not raised
        lats = None
        print(f"batch {len(batches)} failed: {exc!r}", flush=True)
    end = clock()
    for i in ids:
        recs[i].done = end if lats is not None else math.nan
        recs[i].failed = lats is None
    batches.append(Batch(ids, now, end, lats))
    return ids, end


def run_open(queue, serve: Callable, prompt: Callable[[int], np.ndarray],
             offsets: np.ndarray, clock: Callable[[], float],
             sleep: Callable[[float], None]) -> Run:
    """Requests due at ``t0 + offsets``; runs until every one is served."""
    n = len(offsets)
    t0 = clock()
    recs = [Rec(i, t0 + float(o)) for i, o in enumerate(offsets)]
    batches: List[Batch] = []
    nxt, finished = 0, 0
    t_end = t0
    while finished < n:
        now = clock()
        while nxt < n and recs[nxt].due <= now:
            queue.push(Request(arrival=recs[nxt].due, payload=nxt))
            recs[nxt].pushed = now
            nxt += 1
        if queue.ready(now):
            ids, t_end = _serve_batch(queue, serve, recs, batches, prompt, clock)
            finished += len(ids)
            continue
        wake = recs[nxt].due if nxt < n else math.inf
        if len(queue):
            wake = min(wake, now - queue.oldest_wait(now) + queue.max_wait)
        sleep(max(wake - clock(), MIN_SLEEP))
    return Run(recs, batches, t0, t_end)


def run_closed(queue, serve: Callable, prompt: Callable[[int], np.ndarray],
               clients: int, seconds: float, clock: Callable[[], float],
               sleep: Callable[[float], None]) -> Run:
    """``clients`` callers, each sending its next request when its last
    returns.  No batch starts after ``seconds``; the window ends at the
    last completion."""
    t0 = clock()
    recs: List[Rec] = []
    batches: List[Batch] = []

    def send(at):
        recs.append(Rec(len(recs), at, pushed=at))
        queue.push(Request(arrival=at, payload=recs[-1].rid))

    for _ in range(clients):
        send(t0)
    t_end = t0
    while clock() < t0 + seconds:
        now = clock()
        if queue.ready(now):
            ids, t_end = _serve_batch(queue, serve, recs, batches, prompt, clock)
            for _ in ids:
                send(t_end)
            continue
        sleep(max(now - queue.oldest_wait(now) + queue.max_wait - clock(), MIN_SLEEP))
    # requests sent at the close were never served: they are not the window's
    del recs[sum(len(b.rids) for b in batches):]
    return Run(recs, batches, t0, t_end)
