"""The arrival schedule of an open-loop cell, from its traffic file's
``rate_rps`` and the run's seed.

n = ``round(rate * seconds)`` arrivals, the first at 0, whose n - 1 gaps
are the exponential distribution's quantiles at (i + 0.5) / (n - 1),
scaled to a mean of 1 / rate and put in an order drawn from the seed.
Every seed then offers the same count and the same set of gaps, so runs
differ in the order of the bursts only and not in how much work they
offer.
"""
from __future__ import annotations

import numpy as np


def poisson_fixed(rate: float, seconds: float, seed) -> np.ndarray:
    n = max(int(round(rate * seconds)), 1)
    if n == 1:
        return np.zeros(1)
    q = (np.arange(n - 1) + 0.5) / (n - 1)
    gaps = np.random.default_rng(seed).permutation(-np.log1p(-q))
    gaps *= (seconds / n) / gaps.mean()          # mean gap 1 / rate
    return np.concatenate([[0.0], np.cumsum(gaps)])


def offsets(traffic: dict, seconds: float, seed) -> np.ndarray:
    """Arrival times in seconds from the window's start, ascending."""
    return poisson_fixed(traffic["rate_rps"], seconds, seed)
