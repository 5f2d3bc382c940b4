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
bf16 value exactly; a raw two-byte leaf (``V2``, what ``np.load`` returns
for a bf16 array of the reference's checkpoints) is read as bf16 bits.

``params_to_jax`` is the inverse: the port's parameters as the reference's
stacked tree of numpy leaves, f32 leaves as float32 and bf16 leaves as
their raw bits (``V2``), so a checkpoint holds the same bytes either
package wrote.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.configs.base import ModelConfig
from repro_torch.models import stack as ST


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_BITS = np.dtype("V2")


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == BF16_BITS:
        return torch.from_numpy(a.view(np.int16)).to(device).view(torch.bfloat16)
    if a.dtype.name not in _DTYPES:
        raise ValueError(f"parameter of dtype {a.dtype}: want one of {list(_DTYPES)}")
    return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                      dtype=_DTYPES[a.dtype.name])


def _map(tree, fn, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    dictionary trees ``rest``."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


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


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)      # never a view of a parameter
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_BITS)
    if t.dtype != torch.float32:
        raise ValueError(f"parameter of dtype {t.dtype}: want float32 or bfloat16")
    return t.numpy()


def _restack(layers, pl: ST.StackPlan, one, stacked):
    """Per-layer trees -> ``{"blocks", "rem"}``: ``stacked`` over the leaves
    of the repetitions of each pattern position, ``one`` over a remainder
    layer's leaves."""
    blocks = tuple(_map(layers[j], stacked, *[layers[r * pl.period + j]
                                              for r in range(1, pl.n_rep)])
                   for j in range(pl.period if pl.n_rep else 0))
    rem = tuple(_map(layers[pl.n_rep * pl.period + j], one) for j in range(len(pl.rem)))
    return {"blocks": blocks, "rem": rem}


def _to_jax(params, cfg: ModelConfig, one, stacked):
    out = {"embed": one(params["embed"]),
           "stack": _restack(params["stack"], ST.decoder_plan(cfg), one, stacked),
           "final_norm": one(params["final_norm"])}
    if cfg.family == "encdec":
        out["enc_stack"] = _restack(params["enc_stack"], ST.encoder_plan(cfg), one, stacked)
        out["enc_norm"] = one(params["enc_norm"])
    return out


def params_to_jax(params, cfg: ModelConfig):
    """The port's parameters as the reference's stacked pytree of numpy
    leaves: ``stack["blocks"][j]`` holds layers ``r * period + j`` along a
    leading axis of ``n_rep``, ``stack["rem"][j]`` layer
    ``n_rep * period + j``; the same for ``enc_stack``.  bf16 leaves come
    back as raw bits (``V2``); ``params_from_jax`` reads them."""
    return _to_jax(params, cfg, _array,
                   lambda *leaves: np.stack([_array(x) for x in leaves]))


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _meta_stacked(*leaves: torch.Tensor) -> torch.Tensor:
    t = leaves[0]
    return torch.empty((len(leaves),) + tuple(t.shape), dtype=t.dtype, device="meta")


def param_shapes(params, cfg: ModelConfig):
    """The layout of ``params_to_jax`` with meta tensors for leaves: shapes
    and types only, so it takes the port's parameters on any device, meta
    included, and copies nothing (what ``jax.eval_shape`` of the
    reference's ``init`` gives)."""
    return _to_jax(params, cfg, _meta, _meta_stacked)


def cache_shapes(caches, cfg: ModelConfig):
    """The port's decode caches (one dictionary per decoder layer) as meta
    tensors in the reference's stacked cache layout: ``{"blocks": (...),
    "rem": (...)}`` with a leading ``n_rep`` axis on every block leaf."""
    return _restack(caches, ST.decoder_plan(cfg), _meta, _meta_stacked)
