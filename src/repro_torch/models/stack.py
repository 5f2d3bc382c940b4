"""The layer stack, after ``repro/models/stack.py``.

The reference scans over repeated pattern blocks with stacked parameters;
the port keeps a plain list of per-layer parameter and cache dictionaries in
layer order and loops over it in Python (``plan`` is kept: it names the
layer pattern and tells ``convert`` how to unstack reference parameters).

The port runs dense and VLM decoders, embed -> L x [rms_norm -> RoPE GQA
attention -> rms_norm -> MLP or MoE], Mamba2 stacks, whose layers put the
SSD mixer in the attention's place (with the MLP only where ``d_ff > 0``),
the hybrid (jamba) that interleaves the two with MoE on every other layer,
and the enc-dec decoder (whisper), whose layers put rms_norm -> cross-
attention over the encoder's output between the self-attention and the MLP.
A MoE layer adds its balancing loss to the stack's ``aux``.
"""
from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.api import batchwise, constrain, mesh_axis_size
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as MO
from repro_torch.models import ssm as S


class LayerSpec(NamedTuple):
    is_attn: bool
    is_global: bool
    is_moe: bool
    has_cross: bool = False


class StackPlan(NamedTuple):
    period: int
    n_rep: int
    pattern: tuple            # LayerSpec per pattern position
    rem: tuple                # LayerSpec per remainder layer


def _spec(cfg: ModelConfig, i: int, cross: bool) -> LayerSpec:
    return LayerSpec(cfg.is_attn_layer(i), cfg.is_global_layer(i),
                     cfg.is_moe_layer(i), cross)


def plan(cfg: ModelConfig, *, cross: bool = False,
         n_layers: Optional[int] = None) -> StackPlan:
    n = n_layers if n_layers is not None else cfg.n_layers
    period = 1
    if cfg.sliding_window is not None and cfg.global_every > 0:
        period = math.lcm(period, cfg.global_every)
    if cfg.family == "hybrid" and cfg.attn_every > 0:
        period = math.lcm(period, cfg.attn_every)
    if cfg.moe is not None:
        period = math.lcm(period, cfg.moe.every)
    period = min(period, n)
    n_rep = n // period
    pattern = tuple(_spec(cfg, i, cross) for i in range(period))
    rem = tuple(_spec(cfg, n_rep * period + j, cross)
                for j in range(n - n_rep * period))
    return StackPlan(period, n_rep, pattern, rem)


def decoder_plan(cfg: ModelConfig) -> StackPlan:
    """The decoder stack's plan: its layers cross-attend in enc-dec models."""
    return plan(cfg, cross=cfg.family == "encdec")


def encoder_plan(cfg: ModelConfig) -> StackPlan:
    """The enc-dec encoder's plan: ``n_encoder_layers`` layers, no
    cross-attention."""
    return plan(cfg, cross=False, n_layers=cfg.n_encoder_layers)


def layer_specs(cfg: ModelConfig, pl: Optional[StackPlan] = None) -> List[LayerSpec]:
    """One LayerSpec per layer of ``pl`` (the decoder's by default), in
    layer order."""
    pl = pl or decoder_plan(cfg)
    specs = [pl.pattern[j] for _ in range(pl.n_rep) for j in range(pl.period)]
    return specs + list(pl.rem)


def _window(cfg: ModelConfig, spec: LayerSpec) -> Optional[int]:
    if cfg.sliding_window is not None and not spec.is_global:
        return cfg.sliding_window
    return None


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec):
    d, dt = cfg.d_model, cfg.dtype
    p = {"ln1": torch.zeros((d,), dtype=dt, device=gen.device)}
    if spec.is_attn:
        p["attn"] = L.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.head_dim_, dt)
    else:
        p["ssm"] = S.init_mamba(gen, d, cfg.ssm, dt)
    if spec.has_cross:
        p["ln_x"] = torch.zeros((d,), dtype=dt, device=gen.device)
        p["cross"] = L.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.head_dim_, dt)
    if spec.is_moe:
        p["ln2"] = torch.zeros((d,), dtype=dt, device=gen.device)
        p["moe"] = MO.init_moe(gen, d, cfg.moe, cfg.mlp_gated, dt)
    elif cfg.d_ff > 0:
        p["ln2"] = torch.zeros((d,), dtype=dt, device=gen.device)
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.mlp_gated, dt)
    return p


def init_stack(gen: torch.Generator, cfg: ModelConfig, pl: Optional[StackPlan] = None):
    return [init_layer(gen, cfg, spec) for spec in layer_specs(cfg, pl)]


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def _layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, capacity: int,
                 device, enc_len: int = 0):
    if not spec.is_attn:
        s = cfg.ssm
        conv_dim = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
        return {"conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=cfg.dtype,
                                    device=device),
                "state": torch.zeros((batch, s.n_heads(cfg.d_model), s.head_dim,
                                      s.d_state), dtype=torch.float32, device=device)}
    cap = capacity
    if cfg.sliding_window is not None and not spec.is_global:
        cap = min(cfg.sliding_window, capacity)
    shape = (batch, cap, cfg.n_kv_heads, cfg.head_dim_)
    c = {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
         "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    if spec.has_cross:
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim_)
        c["xk"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
        c["xv"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
    return c


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device, enc_len: int = 0):
    return [_layer_cache(cfg, spec, batch, capacity, device, enc_len)
            for spec in layer_specs(cfg)]


# ---------------------------------------------------------------------------
# single layer application
# ---------------------------------------------------------------------------
def layer_apply(params, cfg: ModelConfig, spec: LayerSpec, x, positions, *,
                impl="kernel", moe_impl="einsum", enc_out=None, cache=None,
                at: Optional[DecodeAt] = None, mode="train",
                capacity: Optional[int] = None):
    """Returns (x, new_cache, aux).  ``impl`` picks the kernel, the naive or
    the chunked path of attention (decode takes the naive path for
    ``chunked``, as the reference's decode does), and the kernel or the
    naive path of the SSD scan (``chunked`` runs the naive scan, which is
    what the reference's ``mamba_forward`` runs); ``moe_impl`` the MoE
    dispatch; ``enc_out`` (B, F, d) is the encoder output that a
    cross-attention layer reads outside decode; ``at`` the decode step's
    position (``DecodeAt``); aux is the MoE balancing
    loss (0-d f32), None for a layer without MoE (the reference's zero,
    left out to spare a launch)."""
    aux = None
    new_cache = {}
    with tracing.span("attn" if spec.is_attn else "mamba"):
        h = L.rms_norm(x, params["ln1"], cfg.norm_eps)
        if not spec.is_attn:
            if mode == "decode":
                a, new_cache = S.mamba_decode(params["ssm"], h, cache, cfg.d_model, cfg.ssm)
            else:
                a, st = S.mamba_forward(params["ssm"], h, cfg.d_model, cfg.ssm, impl=impl)
                if mode == "prefill":
                    new_cache = st
        elif mode == "decode":
            a, new_cache = _attn_decode(params["attn"], cfg, h, cache, at, impl)
        else:
            window = _window(cfg, spec)
            a, (k, v) = L.attn_block(params["attn"], h, positions, cfg.rope_theta,
                                     window=window, causal=True, impl=impl)
            if mode == "prefill":
                new_cache = _build_kv_cache(k, v, window, capacity)
        x = x + a
        if spec.has_cross:
            h = L.rms_norm(x, params["ln_x"], cfg.norm_eps)
            if mode == "decode":
                a = _cross_decode(params["cross"], h, cache, impl)
            else:
                a, (xk, xv) = L.cross_attn_block(params["cross"], h, enc_out, impl=impl)
                if mode == "prefill":
                    new_cache["xk"], new_cache["xv"] = xk, xv
            x = x + a
    if "moe" in params:
        with tracing.span("moe"):
            h = L.rms_norm(x, params["ln2"], cfg.norm_eps)
            mo, aux = MO.moe_apply(params["moe"], h, cfg.moe, impl=moe_impl)
            x = x + mo
    elif "mlp" in params:
        with tracing.span("mlp"):
            h = L.rms_norm(x, params["ln2"], cfg.norm_eps)
            x = x + L.mlp(params["mlp"], h)
    # the reference's default layout between layers (its REPRO_SEQ_PARALLEL
    # switch, off by default, is not ported)
    x = constrain(x, "data", None, None)
    return x, new_cache, aux


def _build_kv_cache(k, v, window, capacity):
    """Arrange prefill K/V into the decode cache layout."""
    s = k.shape[1]
    if window is not None:
        cap = min(window, capacity if capacity else window)
        if s >= cap:
            shift = s % cap

            def arrange(x):
                return torch.roll(x[:, -cap:], shift, dims=1)
        else:
            def arrange(x):
                return F.pad(x, (0, 0, 0, 0, 0, cap - s))
    else:
        cap = capacity if capacity else s
        if cap < s:
            raise ValueError(
                f"a prompt of {s} positions does not fit a KV cache of {cap} "
                "slots; raise max_ctx or shorten the prompt")
        if cap == s:
            return {"k": k, "v": v}

        def arrange(x):
            return F.pad(x, (0, 0, 0, 0, 0, cap - s))
    # on a mesh, on each rank's rows: torch 2.11's DTensor has no rule for
    # aten.roll, and its constant_pad_nd rule fails on a mesh of 2 dims
    k, v = batchwise(lambda k, v: (arrange(k), arrange(v)), (k, v))
    return {"k": k, "v": v}


class DecodeAt:
    """Where a decode step writes its K/V and how many slots it reads, built
    once a step from ``cache_len``: a Python int, or a 0-d integer tensor on
    the step's device, so that a step captured in a CUDA graph reads its
    position from the device.  ``pos`` (B, 1) int32 is the new token's
    position, ``slot(cap)`` the slot it takes in a cache of ``cap`` slots
    (``cache_len % cap``: sliding-window caches are rings), an int or a (1,)
    int64 tensor, ``lengths(cap)`` (B,) int32 the slots that hold a
    position, ``min(cache_len + 1, cap)``, and ``valid`` (B,) int32
    ``cache_len + 1``, which the naive path clamps itself."""

    def __init__(self, cache_len, b: int, device):
        self.cache_len, self.b, self.device = cache_len, b, device
        self.on_device = isinstance(cache_len, torch.Tensor)
        self.pos = self._rows(cache_len)[:, None]
        self._slot, self._lengths = {}, {}

    @functools.cached_property
    def valid(self):
        return self._rows(self.cache_len + 1)

    def _rows(self, n):
        if self.on_device:
            return n.to(torch.int32).expand(self.b).contiguous()
        return torch.full((self.b,), n, dtype=torch.int32, device=self.device)

    def slot(self, cap: int):
        if not self.on_device:
            return self.cache_len % cap
        if cap not in self._slot:
            self._slot[cap] = torch.remainder(self.cache_len, cap).to(torch.int64).reshape(1)
        return self._slot[cap]

    def lengths(self, cap: int):
        if cap not in self._lengths:
            n = self.cache_len + 1
            self._lengths[cap] = self._rows(n.clamp(max=cap) if self.on_device else min(n, cap))
        return self._lengths[cap]


def _attn_decode(params, cfg, h, cache, at: DecodeAt, impl):
    """h: (B, 1, d). Insert the new K/V and attend over the cache.

    Outside a mesh the port writes the new slot in place, so the returned
    cache is the one passed in (ROADMAP P3).  On a mesh (DTensor caches) it
    inserts with the reference's masked select, which keeps every shard of
    a sharded cache local, and returns new caches."""
    q = L.project_heads(h, params["wq"])
    k1 = L.project_heads(h, params["wk"])
    v1 = L.project_heads(h, params["wv"])
    # the reference's context-parallel decode plan: where the KV heads do
    # not divide the model axis and the cache is long, the cache's seq dim
    # is model-sharded; replicate the query heads so q.K stays seq-local
    seq_sharded = (cache["k"].shape[-2] % max(mesh_axis_size("model"), 1) != 0
                   and cache["k"].shape[-3] > 8192)
    if seq_sharded:
        q = constrain(q, "data", None, None, None)
        k1 = constrain(k1, "data", None, None, None)
        v1 = constrain(v1, "data", None, None, None)
    q = L.apply_rope(q, at.pos, cfg.rope_theta)
    k1 = L.apply_rope(k1, at.pos, cfg.rope_theta)
    cap = cache["k"].shape[1]
    idx = at.slot(cap)
    if isinstance(cache["k"], DTensor):
        mask = (torch.arange(cap, device=h.device) == idx)[None, :, None, None]
        cache = dict(cache, k=torch.where(mask, k1, cache["k"]),
                     v=torch.where(mask, v1, cache["v"]))
    elif at.on_device:
        cache["k"].index_copy_(1, idx, k1)
        cache["v"].index_copy_(1, idx, v1)
    else:
        cache["k"][:, idx] = k1[:, 0]
        cache["v"][:, idx] = v1[:, 0]
    if impl == "kernel":
        o = ops.decode_attention(q[:, 0], cache["k"], cache["v"], at.lengths(cap))[:, None]
    elif impl in ("naive", "chunked"):     # the reference decodes on its jnp path
        o = L.attention_decode(q, cache["k"], cache["v"], at.valid, seq_sharded=seq_sharded)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    return L.merge_heads(o, params["wo"]), cache


def _cross_decode(params, h, cache, impl):
    """h: (B, 1, d).  The query, without RoPE, over the encoder's K/V that
    prefill left in the cache, every request seeing all F of them (the
    reference's ``attention_decode`` with ``cache_len = F``).  The cross
    caches are read, never written."""
    b, f = cache["xk"].shape[:2]
    q = L.project_heads(h, params["wq"])
    lengths = torch.full((b,), f, dtype=torch.int32, device=h.device)
    if impl == "kernel":
        o = ops.decode_attention(q[:, 0], cache["xk"], cache["xv"], lengths)[:, None]
    elif impl in ("naive", "chunked"):     # the reference decodes on its jnp path
        o = L.attention_decode(q, cache["xk"], cache["xv"], lengths)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    return L.merge_heads(o, params["wo"])


# ---------------------------------------------------------------------------
# full stack application
# ---------------------------------------------------------------------------
def apply_stack(params, cfg: ModelConfig, x, positions, *, impl="kernel",
                moe_impl="einsum", enc_out=None, caches=None, cache_len=None,
                mode="train", capacity=None, remat=False):
    """Returns (x, new_caches, aux_total); new_caches is None in train mode.
    Decode takes its position from ``cache_len`` (an int, or a 0-d integer
    tensor on the device) and ignores ``positions``.  ``remat`` (train
    mode) recomputes each layer's activations in the backward pass
    (``torch.utils.checkpoint`` per layer, the reference's
    ``jax.checkpoint`` per block)."""
    new_caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    at = DecodeAt(cache_len, x.shape[0], x.device) if mode == "decode" else None
    for j, spec in enumerate(layer_specs(cfg)):
        kw = dict(impl=impl, moe_impl=moe_impl, enc_out=enc_out,
                  cache=caches[j] if caches is not None else None,
                  at=at, mode=mode, capacity=capacity)
        if remat and mode == "train":
            x, nc, a = checkpoint(layer_apply, params[j], cfg, spec, x, positions,
                                  use_reentrant=False, **kw)
        else:
            x, nc, a = layer_apply(params[j], cfg, spec, x, positions, **kw)
        new_caches.append(nc)
        if a is not None:
            aux = aux + a
    return x, (new_caches if mode in ("prefill", "decode") else None), aux
