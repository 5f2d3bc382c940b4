"""Workload traces (paper §5.1).

The paper replays four excerpts of the archived 2021-08 Twitter stream
(bursty / steady-low / steady-high / fluctuating) and trains its LSTM on 14
days of the trace.  The archive is not available offline, so we synthesize a
statistically matched stand-in: a diurnal sinusoid + AR(1) noise +
Poisson-seeded exponential-decay bursts, calibrated to the paper's plotted
RPS ranges (~5-40 RPS).  Excerpt generators reproduce the four shapes.

Production-scale extensions (the BENCH_scale scenario): ``TraceConfig.scale``
multiplies the whole synthesized rate curve, lifting a paper-shaped trace
into the thousands-of-RPS regime without changing its shape, and
``scale_excerpt`` generates the two extra stress shapes that regime needs —
``heavy_tailed`` (Pareto-amplitude burst storm: most bursts are small, a
few are enormous) and ``flash_crowd`` (a coordinated step to a multiple of
base load with a sharp ramp and slow decay).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Union

import numpy as np

# seeds accepted everywhere a stream is created: a plain int (legacy,
# bit-compatible), a SeedSequence (the sweep harness's collision-free
# derivation — see ``np.random.SeedSequence.spawn``) or an already-built
# Generator
SeedLike = Union[int, np.random.SeedSequence, np.random.Generator]

try:                                     # vectorized AR(1) (see _ar1_noise)
    from scipy.signal import lfilter as _lfilter
except ImportError:                      # pragma: no cover - scipy is baked in
    _lfilter = None


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Frozen (hashable) so caches can key on the *full* configuration —
    keying on ``seed`` alone silently returned the first-seen config's
    trace for any same-seed config (the PR 6 cache-collision fix)."""
    seed: int = 0
    base_rps: float = 14.0
    diurnal_amp: float = 6.0
    noise_sigma: float = 1.6
    noise_rho: float = 0.95
    burst_rate_per_hour: float = 1.2
    burst_amp: float = 18.0
    burst_decay_s: float = 90.0
    # multiplies the final clipped rate curve: shape-preserving lift into
    # the production regime (scale=1.0 is bit-identical to the pre-knob
    # synthesizer)
    scale: float = 1.0


def _ar1_noise(eps: np.ndarray, rho: float) -> np.ndarray:
    """AR(1) recurrence ``acc = rho * acc + eps[i]`` over the whole array.

    Runs as one C-level IIR filter pass (``scipy.signal.lfilter`` with
    transfer function 1 / (1 - rho z^-1)) — bit-identical to the python
    loop it replaced (same fused multiply-add per step in float64, pinned
    by ``tests/test_trace.py``), and the dominant cost of synthesizing
    21-day predictor traces and 100-pipeline BENCH_scale workloads.
    """
    if _lfilter is not None:
        return _lfilter([1.0], [1.0, -rho], eps)
    noise = np.empty(len(eps))           # pragma: no cover - scipy absent
    acc = 0.0
    for i in range(len(eps)):
        acc = rho * acc + eps[i]
        noise[i] = acc
    return noise


def synth_trace(seconds: int, cfg: TraceConfig = TraceConfig()) -> np.ndarray:
    """Per-second arrival rates (RPS), length ``seconds``."""
    rng = np.random.default_rng(cfg.seed)
    t = np.arange(seconds, dtype=np.float64)
    diurnal = cfg.base_rps + cfg.diurnal_amp * np.sin(2 * np.pi * t / 86_400.0
                                                      - np.pi / 2)
    # AR(1) noise, vectorized (one lfilter pass instead of a python loop)
    eps = rng.standard_normal(seconds) * cfg.noise_sigma * np.sqrt(1 - cfg.noise_rho ** 2)
    noise = _ar1_noise(eps, cfg.noise_rho)
    # bursts
    burst = np.zeros(seconds)
    n_bursts = rng.poisson(cfg.burst_rate_per_hour * seconds / 3600.0)
    for _ in range(n_bursts):
        s0 = rng.integers(seconds)
        amp = cfg.burst_amp * (0.5 + rng.random())
        dur = int(6 * cfg.burst_decay_s)
        idx = np.arange(s0, min(s0 + dur, seconds))
        burst[idx] += amp * np.exp(-(idx - s0) / cfg.burst_decay_s)
    rates = np.clip(diurnal + noise + burst, 0.5, None)
    if cfg.scale != 1.0:
        rates = rates * cfg.scale
    return rates


def make_days(days: int = 21, cfg: TraceConfig = TraceConfig()) -> np.ndarray:
    return synth_trace(days * 86_400, cfg)


# ---------------------------------------------------------------------------
# the four evaluation excerpts (Fig. 7)
#
# The paper trains its LSTM on the first 14 days of the Twitter trace and
# picks the four excerpt shapes from the remaining 7 *unseen* days of the
# SAME trace.  We do the same: scan the test region of the synthesized trace
# for the 10-minute window best matching each shape's statistics, so the
# predictor's train/test distributions match the paper's protocol.
# ---------------------------------------------------------------------------
TRAIN_DAYS = 14
TOTAL_DAYS = 21
TRACE_CACHE_MAX = 8          # full 21-day traces are ~14 MB each


class BoundedTraceCache:
    """LRU-bounded memo for full 21-day traces.

    The pre-PR-7 module-level dict grew without limit: a thousand-cell
    sweep touching many ``TraceConfig``s would pin one 21-day float64
    array (~14 MB) per distinct config for the life of the process.  An
    LRU with a small cap keeps the common case (one or two configs hit
    repeatedly by excerpt mining / predictor training) free while making
    eviction harmless: ``synth_trace`` is a pure function of the config,
    so a re-miss regenerates the exact same bytes (regression-pinned in
    ``tests/test_trace.py``).

    Keyed on the FULL frozen ``TraceConfig`` — two same-seed configs with
    different shape parameters must never share an entry (the PR 6
    cache-collision fix).
    """

    def __init__(self, max_entries: int = TRACE_CACHE_MAX):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self._tab: "OrderedDict[TraceConfig, np.ndarray]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._tab)

    def __contains__(self, cfg: TraceConfig) -> bool:
        return cfg in self._tab

    def get(self, cfg: TraceConfig, builder) -> np.ndarray:
        arr = self._tab.get(cfg)
        if arr is not None:
            self.hits += 1
            self._tab.move_to_end(cfg)
            return arr
        self.misses += 1
        arr = builder(cfg)
        while len(self._tab) >= self.max_entries:
            self._tab.popitem(last=False)
        self._tab[cfg] = arr
        return arr

    def clear(self) -> None:
        self._tab.clear()


_trace_cache = BoundedTraceCache()


def full_trace(cfg: TraceConfig = TraceConfig()) -> np.ndarray:
    return _trace_cache.get(cfg, lambda c: make_days(TOTAL_DAYS, c))


def train_region(cfg: TraceConfig = TraceConfig()) -> np.ndarray:
    return full_trace(cfg)[:TRAIN_DAYS * 86_400]


def test_region(cfg: TraceConfig = TraceConfig()) -> np.ndarray:
    return full_trace(cfg)[TRAIN_DAYS * 86_400:]


def _window_features(w: np.ndarray):
    mean = w.mean()
    return mean, w.std() / (mean + 1e-9), w.max() / (mean + 1e-9)


def excerpt(kind: str, seconds: int = 600,
            cfg: TraceConfig = TraceConfig()) -> np.ndarray:
    test = test_region(cfg)
    stride = max(seconds // 2, 1)
    wins = [(s, test[s:s + seconds]) for s in
            range(0, len(test) - seconds, stride)]
    feats = [(_window_features(w), s, w) for s, w in wins]
    means = np.array([f[0][0] for f in feats])
    lo, hi = np.quantile(means, 0.25), np.quantile(means, 0.75)

    def pick(score_fn):
        best = max(feats, key=lambda f: score_fn(*f[0]))
        return best[2].copy()

    if kind == "steady_low":
        return pick(lambda m, cv, pk: -abs(m - lo) * 5 - cv * 20 - pk)
    if kind == "steady_high":
        return pick(lambda m, cv, pk: -abs(m - hi) * 5 - cv * 20 - pk)
    if kind == "bursty":
        return pick(lambda m, cv, pk: pk)
    if kind == "fluctuating":
        return pick(lambda m, cv, pk: cv - max(pk - 2.5, 0.0))
    raise ValueError(kind)


EXCERPTS = ("bursty", "steady_low", "steady_high", "fluctuating")


# ---------------------------------------------------------------------------
# production-scale stress excerpts (BENCH_scale)
#
# The Fig.-7 shapes cover the paper's 5-40 RPS regime.  A cluster serving
# millions of users additionally sees (a) heavy-tailed burst storms — many
# small spikes, a few enormous ones, the classic self-similar-traffic
# signature — and (b) flash crowds: a coordinated step to a multiple of
# base load (breaking news, a sale going live) with a sharp ramp and a slow
# decay.  These are synthesized directly (not mined from the 21-day trace)
# so the bench controls their magnitude exactly.
# ---------------------------------------------------------------------------
SCALE_EXCERPTS = ("heavy_tailed", "flash_crowd")


def scale_excerpt(kind: str, seconds: int = 600,
                  cfg: TraceConfig = TraceConfig()) -> np.ndarray:
    """Per-second RPS for one production-scale stress shape.

    ``heavy_tailed``: base load plus Poisson-seeded bursts whose amplitudes
    are Pareto-distributed (tail index 1.5): the expected largest burst in a
    window grows with the window, so capacity planning off the mean fails —
    exactly the regime adaptive reconfiguration is for.

    ``flash_crowd``: steady base load until a crowd lands mid-window — a
    few-second ramp to ``burst_amp``x base, a plateau, then exponential
    decay with ``burst_decay_s``.  One event per window, deterministic in
    ``cfg.seed``.

    Both respect ``cfg.scale`` exactly like ``synth_trace``.
    """
    rng = np.random.default_rng(cfg.seed)
    t = np.arange(seconds, dtype=np.float64)
    base = cfg.base_rps + cfg.noise_sigma * _ar1_noise(
        rng.standard_normal(seconds) * np.sqrt(1 - cfg.noise_rho ** 2),
        cfg.noise_rho)
    if kind == "heavy_tailed":
        rates = np.array(base)
        n_bursts = max(int(rng.poisson(
            max(cfg.burst_rate_per_hour, 6.0) * seconds / 3600.0)), 1)
        # Pareto(1.5) amplitudes relative to burst_amp: median ~1.6x, the
        # occasional draw 10-50x — the heavy tail is the point
        amps = cfg.burst_amp * (1.0 + rng.pareto(1.5, n_bursts))
        starts = rng.integers(0, seconds, n_bursts)
        for s0, amp in zip(starts, amps):
            dur = int(4 * cfg.burst_decay_s)
            idx = np.arange(s0, min(s0 + dur, seconds))
            rates[idx] += amp * np.exp(-(idx - s0) / cfg.burst_decay_s)
    elif kind == "flash_crowd":
        rates = np.array(base)
        s0 = int(rng.integers(seconds // 4, seconds // 2))
        ramp_s = max(int(rng.integers(3, 9)), 1)
        plateau_s = int(cfg.burst_decay_s)
        peak = cfg.burst_amp * max(cfg.base_rps, 1.0)
        ramp = np.minimum((t - s0) / ramp_s, 1.0)
        hold = np.where(t < s0 + ramp_s + plateau_s, 1.0,
                        np.exp(-(t - s0 - ramp_s - plateau_s)
                               / cfg.burst_decay_s))
        rates += np.where(t >= s0, peak * ramp * hold, 0.0)
    else:
        raise ValueError(kind)
    rates = np.clip(rates, 0.5, None)
    if cfg.scale != 1.0:
        rates = rates * cfg.scale
    return rates


def arrivals_from_rates(rates: np.ndarray, seed: SeedLike = 0) -> np.ndarray:
    """Poisson-sample concrete arrival timestamps from per-second rates.

    ``seed`` may be an int (legacy, bit-compatible), a
    ``np.random.SeedSequence`` (what the sweep harness derives per cell —
    spawned children are collision-free by construction, unlike
    arithmetic on a base int) or a ``Generator``.
    """
    rng = np.random.default_rng(seed)
    times = []
    for sec, lam in enumerate(rates):
        n = rng.poisson(lam)
        times.extend(sec + np.sort(rng.random(n)))
    return np.asarray(times)
