"""Pipeline accuracy metrics (paper §4.1 + Appendix C).

PAS  (Eq. 8): product of per-stage accuracies (kept on a 0-100 scale:
             100 * prod(a_s / 100), matching the paper's plotted ranges).
PAS' (Eq. 11): sum of rank-normalized per-stage accuracies (Appendix C) —
             the linear alternative; both must rank configurations
             consistently in the end-to-end experiments.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.pipeline import PipelineConfig, PipelineModel


def pas(accs: Sequence[float]) -> float:
    """accs: chosen per-stage accuracies in [0, 100]."""
    p = 100.0
    for a in accs:
        p *= a / 100.0
    return p


def pas_of(config: PipelineConfig, pipe: PipelineModel) -> float:
    return pas([st.variant(sc.variant).acc(sc.device)
                for sc, st in zip(config.stages, pipe.stages)])


def rank_normalized(accuracies: Sequence[float]) -> np.ndarray:
    """Scale a stage's variant accuracies to [0, 1] by rank (Appendix C)."""
    a = np.asarray(accuracies, dtype=np.float64)
    order = np.argsort(np.argsort(a))
    if len(a) == 1:
        return np.ones(1)
    return order / (len(a) - 1.0)


def pas_prime_tables(pipe: PipelineModel):
    """Per-stage rank-normalized accuracy lookup for PAS' (Eq. 11), keyed
    ``(variant name, device class)``.  Ranks run over the stage's flattened
    (variant, class) accuracy list in declaration order — for single-class
    stages that is exactly the legacy per-variant ranking."""
    out = []
    for st in pipe.stages:
        pairs = [(v.name, d) for v in st.variants for d in v.device_classes]
        accs = [st.variant(n).acc(d) for n, d in pairs]
        out.append(dict(zip(pairs, rank_normalized(accs))))
    return out


def pas_prime_of(config: PipelineConfig, pipe: PipelineModel) -> float:
    tables = pas_prime_tables(pipe)
    return float(sum(t[(sc.variant, sc.device)]
                     for t, sc in zip(tables, config.stages)))
