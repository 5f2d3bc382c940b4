"""Queueing model (paper Eq. 7, from FA2): worst-case batch-formation delay,
plus an opt-in expected-delay model (M/M/c-style).

The first request of a batch waits for the remaining (b - 1) requests; at
arrival rate lambda the worst case is q(b) = (b - 1) / lambda.  That bound
is what the paper plans against; ``expected_wait`` instead estimates the
*expected* delay (mean batch-formation wait + Erlang-C queue wait across
the stage's replicas), selected by ``latency_model="expected"`` in
``optimizer.stage_options`` / ``PipelineConfig.latency``.  The default
(worst-case) path is untouched.

Both the analytical planner (``PipelineConfig.latency`` -> ``queue_delay``)
and the discrete-event simulator (batch-formation timeout ->
``wait_bound``) derive from this single implementation so the optimizer's
latency estimate and the simulator's dispatch behaviour can never drift
apart.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def queue_delay(batch, arrival_rps) -> np.ndarray:
    """Worst-case batch-formation delay q(b) = (b - 1) / lambda (Eq. 7).

    Zero-demand semantics (defined here, once, for the whole stack): at
    lambda <= 0 only a batch of one is meaningfully priced — it never
    waits, so its delay is 0; any larger batch would wait forever for
    peers that never arrive, so its delay is ``inf``.  The planner's
    feasibility masks (``lat <= sla``) reject those options, and the
    simulator's batch-formation timeout caps the bound at ``max_wait``
    (see ``wait_bound``) — both therefore behave sanely on an idle
    interval instead of pricing batches at ~1e9·(b-1) seconds.
    """
    batch = np.asarray(batch, dtype=np.float64)
    lam = float(arrival_rps)
    if lam <= 0.0:
        return np.where(batch > 1.0, np.inf, 0.0)
    return (batch - 1.0) / lam


def expected_wait(batch: int, arrival_rps: float, replicas: int = 1,
                  service_time: Optional[float] = None) -> float:
    """Expected batch-formation + queue delay (M/M/c-style).

    Batch formation: a random request in a forming batch of ``b`` waits on
    average for the later ``(b - 1) / 2`` of its peers, so the mean wait is
    ``(b - 1) / (2 lambda)`` — exactly half of Eq. 7's worst case (the head
    request waiting for all ``b - 1``), hence always <= ``queue_delay``.

    Queue delay (only when ``service_time`` is given): formed batches
    arrive ~Poisson at ``lambda / b`` and are served by ``replicas``
    servers each taking ``service_time`` per batch; the expected wait is
    the M/M/c Erlang-C formula.  Returns ``inf`` when the stage is
    unstable (offered load >= replicas), which feasibility masks treat as
    a latency violation.
    """
    b = int(batch)
    lam = float(arrival_rps)
    if lam <= 0.0:
        # zero demand: same semantics as ``queue_delay`` — a batch of one
        # never waits, anything larger waits forever
        return 0.0 if b <= 1 else float("inf")
    form = (b - 1) / (2.0 * lam)
    if service_time is None:
        return form
    st = float(service_time)
    if st <= 0.0:
        return form
    c = max(int(replicas), 1)
    lam_b = lam / max(b, 1)              # batch arrival rate
    mu = 1.0 / st                        # per-server batch service rate
    a = lam_b / mu                       # offered load (erlangs)
    if a >= c:
        return float("inf")
    # Erlang C, computed iteratively to stay overflow-free at large c
    term = 1.0
    s = 1.0                              # sum_{k=0}^{c-1} a^k / k!
    for k in range(1, c):
        term *= a / k
        s += term
    top = term * a / c * c / (c - a)     # a^c / c! * c / (c - a)
    p_wait = top / (s + top)
    return form + p_wait / (c * mu - lam_b)


def wait_bound(batch: int, arrival_rps: float,
               max_wait: Optional[float] = None) -> float:
    """Batch-formation timeout: Eq. 7's q(b) capped at ``max_wait``.

    This is the deadline the simulator arms for a partially filled batch:
    the head request never waits longer than the worst-case queue delay the
    planner budgeted for, nor longer than the hard cap ``max_wait``.  A
    batch of one never waits.  At zero demand ``queue_delay`` is ``inf``
    for b > 1 (see its zero-demand semantics), so the timeout degrades to
    exactly ``max_wait`` — the same deadline the old 1e-9 clamp produced.
    """
    if batch <= 1:
        return 0.0
    q = float(queue_delay(batch, arrival_rps))
    if max_wait is not None:
        q = min(float(max_wait), q)
    return q
