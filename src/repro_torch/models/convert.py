"""Parameters of the reference package, as numpy leaves, into the port's
layout.

The reference stacks the parameters of repeated pattern blocks:
``stack["blocks"][j]`` holds pattern position ``j`` of every repetition ``r``
along a leading axis, which is layer ``r * period + j``; ``stack["rem"][j]``
is layer ``n_rep * period + j``.  The port keeps one dictionary per layer,
for the decoder's ``stack`` and an enc-dec model's ``enc_stack`` alike (each
unstacked with its own plan).
Each leaf keeps its own type: a bf16 model's ``A_log``, ``D`` and
``dt_bias`` and a MoE layer's ``router`` stay f32, as in the reference.  bf16 leaves
(``ml_dtypes.bfloat16`` arrays) pass through float32, which holds every
bf16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.configs.base import ModelConfig
from repro_torch.models import stack as ST


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name not in _DTYPES:
        raise ValueError(f"parameter of dtype {a.dtype}: want one of {list(_DTYPES)}")
    return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                      dtype=_DTYPES[a.dtype.name])


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(stack_np, pl: ST.StackPlan, conv):
    layers = [None] * (pl.n_rep * pl.period + len(pl.rem))
    for j, block in enumerate(stack_np["blocks"]):
        for r in range(pl.n_rep):
            layers[r * pl.period + j] = _map(block, lambda a: conv(a[r]))
    for j, layer in enumerate(stack_np["rem"]):
        layers[pl.n_rep * pl.period + j] = _map(layer, conv)
    return layers


def params_from_jax(params_np, cfg: ModelConfig, *, device: D.DeviceLike = None):
    """``params_np``: the reference's parameter pytree with numpy leaves
    (for example ``jax.tree.map(np.asarray, params)``)."""
    dev = D.resolve(device)
    conv = lambda a: _tensor(a, dev)  # noqa: E731
    params = {"embed": conv(params_np["embed"]),
              "stack": _unstack(params_np["stack"], ST.decoder_plan(cfg), conv),
              "final_norm": conv(params_np["final_norm"])}
    if cfg.family == "encdec":
        params["enc_stack"] = _unstack(params_np["enc_stack"], ST.encoder_plan(cfg), conv)
        params["enc_norm"] = conv(params_np["enc_norm"])
    return params
