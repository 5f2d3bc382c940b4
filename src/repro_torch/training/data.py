"""Synthetic data pipeline, after ``repro/training/data.py``.

Deterministic, seekable token stream with learnable structure (a randomly
drawn order-1 Markov chain over the vocabulary), so a ~100M model trained
for a few hundred steps shows a cleanly decreasing loss.  Multimodal
architectures additionally get stub frame/patch embeddings correlated with
the token stream prefix so the backbone has cross-modal signal to exploit.

``DataConfig`` and ``SyntheticStream`` are numpy, copied from the
reference: batch ``i`` of a seed is the reference's, bit for bit.
``input_specs`` gives meta tensors in place of ``jax.ShapeDtypeStruct``.
``to_device`` with a ``mesh`` places a batch as the reference's
``P("data", None)`` does: rows over ``data``, replicated over ``model``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd


@dataclasses.dataclass
class DataConfig:
    seq_len: int = 256
    batch_size: int = 8
    seed: int = 0
    markov_concentration: float = 0.3   # lower = more predictable stream


class SyntheticStream:
    """Order-1 Markov token stream; batch ``i`` is reproducible from (seed, i)."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig):
        self.cfg = cfg
        self.dcfg = dcfg
        rng = np.random.default_rng(dcfg.seed)
        v = cfg.vocab
        probs = rng.dirichlet(np.full(min(v, 64), dcfg.markov_concentration),
                              size=v)
        # each row transitions among 64 random successor states
        succ = np.stack([rng.choice(v, size=min(v, 64), replace=False)
                         for _ in range(v)])
        self._succ = succ.astype(np.int32)
        self._cum = np.cumsum(probs, axis=1).astype(np.float64)

    def _walk(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = np.empty(n, np.int32)
        state = int(rng.integers(self.cfg.vocab))
        u = rng.random(n)
        for i in range(n):
            j = int(np.searchsorted(self._cum[state], u[i]))
            j = min(j, self._succ.shape[1] - 1)
            state = int(self._succ[state, j])
            out[i] = state
        return out

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        d, c = self.dcfg, self.cfg
        rng = np.random.default_rng((d.seed, index))
        toks = np.stack([self._walk(rng, d.seq_len + 1)
                         for _ in range(d.batch_size)])
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        if c.family == "encdec":
            emb = rng.standard_normal((d.batch_size, c.encoder_seq, c.d_model))
            out["frames"] = emb.astype(np.float32) * 0.02
        if c.family == "vlm":
            emb = rng.standard_normal((d.batch_size, c.n_patches, c.d_model))
            out["patches"] = emb.astype(np.float32) * 0.02
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


def to_device(batch: Dict[str, np.ndarray], device, mesh=None) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``: token ids and labels int64,
    the stub embeddings f32 (the model casts them to its type); with a
    ``DeviceMesh``, DTensors with their rows over its ``data`` axis (every
    rank passes the same batch and keeps its rows)."""
    out = {k: torch.from_numpy(np.asarray(v, np.int64 if v.dtype.kind == "i" else v.dtype))
           .to(device) for k, v in batch.items()}
    if mesh is None:
        return out
    data = shd.MeshAxes.of(mesh).data
    rows = data if len(data) > 1 else data[0]
    return shd.distribute(out, mesh, {k: shd.P(rows, *[None] * (v.dim() - 1))
                                      for k, v in out.items()})


def input_specs(cfg: ModelConfig, seq_len: int, batch: int, kind: str,
                dtype=None):
    """Meta-tensor stand-ins for every model input (dry-run path)."""
    dtype = dtype or cfg.dtype
    sds = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")  # noqa: E731
    if kind == "train":
        out = {"tokens": sds((batch, seq_len), torch.int32),
               "labels": sds((batch, seq_len), torch.int32)}
    elif kind == "prefill":
        out = {"tokens": sds((batch, seq_len), torch.int32)}
    elif kind == "decode":
        out = {"tokens": sds((batch, 1), torch.int32)}
    else:
        raise ValueError(kind)
    if cfg.family == "encdec" and kind != "decode":
        out["frames"] = sds((batch, cfg.encoder_seq, cfg.d_model), dtype)
    if cfg.family == "vlm" and kind != "decode":
        out["patches"] = sds((batch, cfg.n_patches, cfg.d_model), dtype)
    return out
