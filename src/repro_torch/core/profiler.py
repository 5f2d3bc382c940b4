"""Offline profiler (paper §4.2).

* measures model latency at power-of-two batch sizes 1..64,
* fits the quadratic l(b) = a b^2 + b1 b + c (lower MSE than linear, §4.2),
* solves Eq. 1 for the base resource allocation R_m: the minimum allocation
  whose throughput clears the threshold `th` while the largest batch stays
  within the per-stage SLA,
* derives per-stage SLAs a la Swayam: 5 x mean batch-1 latency across the
  task's variants.

Hardware adaptation note: the port profiles on one card, so scaling across
allocations cannot be *measured*.  ``alloc_speedup`` models
l(b; R) = l(b; 1) / R^0.75 (sub-linear parallel scaling, consistent with the
paper's Table 2 where 8 cores give ResNet18 75->14 ms ~ 5.4x).  On a real
cluster this function is replaced by measurements.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pipeline import (BATCH_CHOICES, ModelVariant, PipelineModel,
                                 StageModel)

ALLOC_CHOICES = (1, 2, 4, 8, 16, 32)
SLA_MULTIPLIER = 5.0          # Swayam heuristic (§4.2)
SPEEDUP_EXP = 0.75


def alloc_speedup(r: int) -> float:
    return float(r) ** SPEEDUP_EXP


def fit_quadratic(batches: Sequence[int], lats: Sequence[float]):
    """Least-squares fit of l(b) = a b^2 + b1 b + c; clipped to be
    non-decreasing and positive on the profiled range."""
    b = np.asarray(batches, np.float64)
    y = np.asarray(lats, np.float64)
    A = np.stack([b ** 2, b, np.ones_like(b)], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    a, b1, c = (float(x) for x in coef)
    if c <= 0:
        c = float(max(y.min() * 0.5, 1e-6))
    return a, b1, c


def fit_mse(batches, lats, coeffs) -> float:
    b = np.asarray(batches, np.float64)
    y = np.asarray(lats, np.float64)
    a, b1, c = coeffs
    return float(np.mean((a * b ** 2 + b1 * b + c - y) ** 2))


def fit_linear_mse(batches, lats) -> float:
    b = np.asarray(batches, np.float64)
    y = np.asarray(lats, np.float64)
    A = np.stack([b, np.ones_like(b)], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    return float(np.mean((A @ coef - y) ** 2))


@dataclasses.dataclass
class Profile:
    name: str
    batches: List[int]
    latencies: List[float]               # seconds at R = 1
    accuracy: float
    params_m: float = 0.0

    def coeffs(self):
        return fit_quadratic(self.batches, self.latencies)


def measure_latency(fn: Callable[[int], None], batches=BATCH_CHOICES,
                    warmup: int = 1, repeats: int = 3) -> List[float]:
    """Wall-clock profile of ``fn(batch_size)`` per batch size."""
    out = []
    for b in batches:
        for _ in range(warmup):
            fn(b)
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn(b)
        out.append((time.perf_counter() - t0) / repeats)
    return out


def profile_stage_server(server, batches=(1, 2, 4, 8), prompt_len: int = 16,
                         repeats: int = 2) -> List[Profile]:
    """Profile every variant of a real serving StageServer (the torch engine)."""
    import numpy as _np
    profs = []
    for vname, (cfg, acc) in server.variants.items():
        server.set_variant(vname)

        def run(b):
            toks = _np.zeros((b, prompt_len), _np.int32)
            server.process(toks)

        lats = measure_latency(run, batches=batches, warmup=1, repeats=repeats)
        profs.append(Profile(vname, list(batches), lats, acc))
    return profs


# ---------------------------------------------------------------------------
# Eq. 1: base allocation
# ---------------------------------------------------------------------------
def base_allocation(profile: Profile, th: float, sla_s: float,
                    max_batch: int = max(BATCH_CHOICES),
                    allocs=ALLOC_CHOICES) -> Optional[int]:
    """min R s.t. throughput(batch=1; R) >= th and l(max_batch; R) <= SLA_s."""
    a, b1, c = profile.coeffs()
    for r in allocs:
        sp = alloc_speedup(r)
        lat1 = (a + b1 + c) / sp
        lat_max = (a * max_batch ** 2 + b1 * max_batch + c) / sp
        if 1.0 / lat1 >= th and lat_max <= sla_s:
            return r
    return None


def derive_stage_sla(profiles: Sequence[Profile]) -> float:
    """Swayam: 5 x mean batch-1 latency over the task's variants (§4.2)."""
    lat1 = [p.coeffs()[0] + p.coeffs()[1] + p.coeffs()[2] for p in profiles]
    return SLA_MULTIPLIER * float(np.mean(lat1))


def build_stage(name: str, profiles: Sequence[Profile], th: float,
                batch_choices=BATCH_CHOICES, sla: Optional[float] = None,
                max_batch: Optional[int] = None) -> StageModel:
    """Profiler output -> control-plane StageModel (variants w/ Eq.-1 allocs).

    Variants whose Eq.-1 allocation does not exist (cannot meet th/SLA at any
    allocation) are excluded, mirroring the 'x' cells of Table 5.
    """
    sla_s = sla if sla is not None else derive_stage_sla(profiles)
    mb = max_batch if max_batch is not None else max(batch_choices)
    variants = []
    for p in profiles:
        r = base_allocation(p, th, sla_s, max_batch=mb)
        if r is None:
            continue
        a, b1, c = p.coeffs()
        sp = alloc_speedup(r)
        variants.append(ModelVariant(
            name=p.name, accuracy=p.accuracy, base_alloc=r,
            latency_coeffs=(a / sp, b1 / sp, c / sp), params_m=p.params_m))
    if not variants:
        raise ValueError(f"no variant of stage {name} meets th={th}, sla={sla_s}")
    return StageModel(name=name, variants=tuple(variants), sla=sla_s,
                      batch_choices=tuple(batch_choices))
