"""Parameters of the reference package, as numpy leaves, into the port's
layout.

The reference stacks the parameters of repeated pattern blocks:
``stack["blocks"][j]`` holds pattern position ``j`` of every repetition ``r``
along a leading axis, which is layer ``r * period + j``; ``stack["rem"][j]``
is layer ``n_rep * period + j``.  The port keeps one dictionary per layer.
bf16 leaves (``ml_dtypes.bfloat16`` arrays) pass through float32, which
holds every bf16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.configs.base import ModelConfig
from repro_torch.models import stack as ST


def _tensor(a, dtype, device):
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(device=device, dtype=dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(params_np, cfg: ModelConfig, *, device: D.DeviceLike = None):
    """``params_np``: the reference's parameter pytree with numpy leaves
    (for example ``jax.tree.map(np.asarray, params)``)."""
    dev = D.resolve(device)
    ST.layer_specs(cfg)   # raises for the layer kinds of later slices
    pl = ST.plan(cfg)
    conv = lambda a: _tensor(a, cfg.dtype, dev)  # noqa: E731
    layers = [None] * cfg.n_layers
    for j, block in enumerate(params_np["stack"]["blocks"]):
        for r in range(pl.n_rep):
            layers[r * pl.period + j] = _map(block, lambda a: conv(a[r]))
    for j, layer in enumerate(params_np["stack"]["rem"]):
        layers[pl.n_rep * pl.period + j] = _map(layer, conv)
    return {"embed": conv(params_np["embed"]), "stack": layers,
            "final_norm": conv(params_np["final_norm"])}
