"""Top-level model API of the dense, VLM, MoE, Mamba2 (``ssm``) and hybrid
families, after ``repro/models/model.py``.

  init(cfg, seed=, device=)                -> params
  forward(params, cfg, batch, ...)         -> (hidden (B,S,d), aux)
  logits(params, cfg, hidden)              -> (B, S, V)
  prefill(params, cfg, batch, ...)         -> (hidden_last (B,d), caches, prompt_len)
  decode_step(params, cfg, caches, t, tok) -> (logits (B,V), caches)

``batch`` keys: "tokens" (B,S) integer tensor always; "patches" (B,P,d) for
vlm (the projected patch stub), prepended to the token embeddings.  The
decode path operates past the prefix.  Parameters are a dictionary:
``embed`` (V, d), ``stack`` (a list of per-layer dictionaries in layer
order) and ``final_norm`` (d,).  A layer's cache is ``{"k", "v"}`` for
attention and ``{"conv", "state"}`` (the last ``d_conv - 1`` conv inputs in
the model's type, the SSM state in f32) for Mamba2; ``impl`` picks the
kernels or the naive paths of attention and the SSD scan alike, and
``moe_impl`` the MoE dispatch (``einsum``, the reference's default, or
``gather``).  ``aux`` is the sum of the MoE layers' balancing losses, a 0-d
f32 tensor that is zero for models without MoE.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import device as D
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import stack as ST


def init(cfg: ModelConfig, *, seed: int = 0, device: D.DeviceLike = None):
    """Random parameters with the reference's distributions, drawn from a
    generator seeded with ``seed`` on ``device`` (the card by default).  The
    numbers differ from ``repro.models.model.init``'s: tests that compare
    the two packages convert the reference's parameters instead."""
    gen = torch.Generator(device=D.resolve(device)).manual_seed(seed)
    emb = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                      dtype=torch.float32, device=gen.device)
    return {
        "embed": (emb * (1.0 / cfg.d_model ** 0.5)).to(cfg.dtype),
        "stack": ST.init_stack(gen, cfg),
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=gen.device),
    }


def _embed_with_prefix(params, cfg: ModelConfig, batch):
    x = params["embed"][batch["tokens"]]
    if cfg.family == "vlm" and "patches" in batch:
        prefix = batch["patches"].to(x.dtype)
        return torch.cat([prefix, x], dim=1), prefix.shape[1]
    return x, 0


def _positions(b: int, s: int, device):
    return torch.arange(s, device=device)[None].expand(b, s)


def forward(params, cfg: ModelConfig, batch, *, impl="kernel", moe_impl="einsum"):
    """Full-sequence forward; returns (the final-normed hidden states past
    the prefix, aux)."""
    x, n_prefix = _embed_with_prefix(params, cfg, batch)
    b, s = x.shape[:2]
    x, _, aux = ST.apply_stack(params["stack"], cfg, x, _positions(b, s, x.device),
                               impl=impl, moe_impl=moe_impl, mode="train")
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, n_prefix:], aux


def logits(params, cfg: ModelConfig, hidden):
    return hidden @ params["embed"].T


def prefill(params, cfg: ModelConfig, batch, *, impl="kernel", moe_impl="einsum",
            capacity: Optional[int] = None):
    """Process the prompt; returns (hidden_last (B, d), caches, prompt_len)."""
    x, _ = _embed_with_prefix(params, cfg, batch)
    b, s = x.shape[:2]
    x, caches, _ = ST.apply_stack(params["stack"], cfg, x, _positions(b, s, x.device),
                                  impl=impl, moe_impl=moe_impl, mode="prefill",
                                  capacity=capacity if capacity else s)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, -1], caches, s


def decode_step(params, cfg: ModelConfig, caches, cache_len: int, tokens, *,
                impl="kernel", moe_impl="einsum"):
    """tokens: (B, 1) integer tensor; cache_len: the current context length.

    Returns (logits (B, V), caches).  Attention layers update their KV
    caches in place; Mamba2 layers return a new conv window and state."""
    x = params["embed"][tokens]
    x, caches, _ = ST.apply_stack(params["stack"], cfg, x, None, impl=impl,
                                  moe_impl=moe_impl, caches=caches,
                                  cache_len=cache_len, mode="decode")
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["embed"].T)[:, 0], caches


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device: D.DeviceLike = None):
    return ST.init_cache(cfg, batch, capacity, D.resolve(device))
