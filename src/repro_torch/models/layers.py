"""Shared building blocks of the attention families, after
``repro/models/layers.py``.

Functions take parameters as dictionaries of tensors, in the reference's
layouts (``wq`` is (d, H, hd), ``wo`` is (H, hd, d)), and keep its numerics:
RMS norm in f32 with the ``1 + scale`` form, half-split RoPE with f32
angles, tanh-approximated GELU (``jax.nn.gelu``'s default) and the finite
``-1e30`` mask.  Attention offers three implementations:

  * ``naive``   -- materializes the (S, S) score matrix (the oracle),
  * ``chunked`` -- the reference's default: query chunks of
                   ``DEFAULT_QUERY_CHUNK`` in a Python loop, each over the
                   KV slab it can see, in plain PyTorch (trainable),
  * ``kernel``  -- ``repro_torch.kernels.ops.flash_attention``: the CUDA
                   kernel on the card, its plain version on the CPU.  It
                   has no backward and refuses inputs that require grad.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.api import constrain, einsum, whole_pieces
from repro_torch.kernels import ops

NEG_INF = -1e30
DEFAULT_QUERY_CHUNK = 1024


# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------
def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype):
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * (1.0 / d_in ** 0.5)).to(dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature factor (DeepSeek-V3's ``yarn_get_mscale``)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_freqs(head_dim: int, theta: float, yarn, device=None):
    """DeepSeek-V3's YaRN inverse frequencies: the rotation pairs below the
    correction range keep ``theta ** (-2i / hd)``, those above it are
    divided by ``factor``, with a linear ramp between.  The range's ends are
    the pair indices at which a rotation turns ``beta_fast`` (floored) and
    ``beta_slow`` (ceiled) times over ``original_max_position_embeddings``."""
    def dim_at(rotations):
        return (head_dim * math.log(yarn.original_max_position_embeddings
                                    / (rotations * 2 * math.pi)) / (2 * math.log(theta)))
    low = max(math.floor(dim_at(yarn.beta_fast)), 0)
    high = min(math.ceil(dim_at(yarn.beta_slow)), head_dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    base = rope_freqs(head_dim, theta, device)
    return base / yarn.factor * ramp + base * (1 - ramp)


def apply_rope(x, positions, theta: float, freqs=None):
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S).
    ``freqs`` (head_dim / 2,) f32 replaces ``rope_freqs(head_dim, theta)``."""
    if freqs is None:
        freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs                 # (..., S, hd/2)
    sin = torch.sin(angles)[..., None, :]                          # (..., S, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def init_mlp(gen, d_model: int, d_ff: int, gated: bool, dtype):
    p = {"w_in": init_dense(gen, d_model, d_ff, dtype),
         "w_out": init_dense(gen, d_ff, d_model, dtype)}
    if gated:
        p["w_gate"] = init_dense(gen, d_model, d_ff, dtype)
    return p


def mlp(params, x):
    h = x @ params["w_in"]
    if "w_gate" in params:
        h = F.silu(x @ params["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")
    h = constrain(h, "data", None, "model")
    return h @ params["w_out"]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def init_attention(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int, dtype):
    return {
        "wq": init_dense(gen, d_model, n_heads * head_dim, dtype).view(d_model, n_heads, head_dim),
        "wk": init_dense(gen, d_model, n_kv * head_dim, dtype).view(d_model, n_kv, head_dim),
        "wv": init_dense(gen, d_model, n_kv * head_dim, dtype).view(d_model, n_kv, head_dim),
        "wo": init_dense(gen, n_heads * head_dim, d_model, dtype).view(n_heads, head_dim, d_model),
    }


def project_heads(x, w):
    """x: (B, S, d); w: (d, heads, hd) -> contiguous (B, S, heads, hd)."""
    d, heads, hd = w.shape
    return whole_pieces(x @ w.reshape(d, heads * hd), -1, heads).view(*x.shape[:-1], heads, hd)


def merge_heads(o, wo):
    """o: (B, S, H, hd); wo: (H, hd, d) -> (B, S, d)."""
    h, hd, d = wo.shape
    return whole_pieces(o.reshape(*o.shape[:-2], h * hd), -1, h) @ wo.reshape(h * hd, d)


def _repeat_kv(k, n_heads: int):
    """(B, S, n_kv, hd) -> (B, S, n_heads, hd) by group broadcast."""
    n_kv = k.shape[-2]
    if n_kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // n_kv, dim=-2)


def _mask_bias(q_pos, k_pos, window: Optional[int]):
    """Additive causal (+ sliding window) mask bias: (..., Sq, Sk) float32."""
    ok = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        ok &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, NEG_INF)


def attention_naive(q, k, v, q_pos, k_pos, window: Optional[int] = None,
                    causal: bool = True, scale: Optional[float] = None):
    """q: (B, Sq, H, hd); k: (B, Sk, Kv, hd); v: (B, Sk, Kv, hd_v). Returns
    (B, Sq, H, hd_v).  ``scale`` defaults to 1 / sqrt(hd)."""
    h = q.shape[-2]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    scale = 1.0 / q.shape[-1] ** 0.5 if scale is None else scale
    scores = einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        scores = scores + _mask_bias(q_pos, k_pos, window)[:, None]
    probs = torch.softmax(scores, dim=-1)
    return einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def attention_chunked(q, k, v, q_pos, k_pos, window: Optional[int] = None,
                      causal: bool = True, query_chunk: int = DEFAULT_QUERY_CHUNK,
                      scale: Optional[float] = None):
    """The reference's ``attention_chunked``: the queries in chunks of
    ``query_chunk``, each chunk's scores and softmax over the keys it can
    see.  For a causal window that is a KV slab of
    ``((window + C + 127) // 128) * 128`` keys, so prefill costs
    O(S * (C + W)) instead of O(S^2).  Falls back to the naive path when Sq
    is not a multiple of the chunk or is one chunk."""
    b, sq, hq, hd = q.shape
    sk = k.shape[1]
    if sq % query_chunk != 0 or sq == query_chunk:
        return attention_naive(q, k, v, q_pos, k_pos, window, causal, scale)
    k = _repeat_kv(k, hq)
    v = _repeat_kv(v, hq)
    scale = 1.0 / hd ** 0.5 if scale is None else scale
    slab = sk
    if window is not None and causal:
        slab = min(sk, ((window + query_chunk + 127) // 128) * 128)
    outs = []
    for i in range(sq // query_chunk):
        rows = slice(i * query_chunk, (i + 1) * query_chunk)
        # chunk i covers queries [i*C, (i+1)*C); the first key it can see
        start = min(max(i * query_chunk + query_chunk - slab, 0), sk - slab)
        keys = slice(start, start + slab)
        s = einsum("bqhd,bkhd->bhqk", q[:, rows].float(), k[:, keys].float()) * scale
        if causal:
            s = s + _mask_bias(q_pos[:, rows], k_pos[:, keys], window)[:, None]
        p = torch.softmax(s, dim=-1)
        outs.append(einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v[:, keys]))
    return torch.cat(outs, dim=1)


def attention_decode(q, k_cache, v_cache, cache_len, seq_sharded: bool = False):
    """Single-token decode attention, the jnp path of the reference.

    q: (B, 1, H, hd); caches: (B, L, Kv, hd) where L is the cache capacity
    (ring buffer for sliding-window layers).  ``cache_len`` (B,) is the
    number of valid entries (== absolute position + 1 for full caches).
    ``seq_sharded``: the cache's seq dim is context-parallel over ``model``;
    on a mesh the scores and probabilities stay sharded along it, as the
    reference constrains them.
    """
    hq, hd = q.shape[-2], q.shape[-1]
    L = k_cache.shape[1]
    k = _repeat_kv(k_cache, hq)
    v = _repeat_kv(v_cache, hq)
    scores = einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / hd ** 0.5)
    idx = torch.arange(L, device=q.device)[None, :]
    valid = idx < torch.clamp(cache_len, max=L)[:, None]    # ring buffer: all L valid once full
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    if seq_sharded:
        scores = constrain(scores, "data", None, None, "model")
    p = torch.softmax(scores, dim=-1)
    if seq_sharded:
        p = constrain(p, "data", None, None, "model")
    return einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def attention(q, k, v, q_pos, k_pos, window=None, causal=True, impl="kernel", scale=None):
    if impl == "naive":
        return attention_naive(q, k, v, q_pos, k_pos, window, causal, scale)
    if impl == "chunked":
        return attention_chunked(q, k, v, q_pos, k_pos, window, causal, scale=scale)
    if impl == "kernel":
        return ops.flash_attention(q, k, v, q_pos, k_pos, window=window, causal=causal,
                                   scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")


# ---------------------------------------------------------------------------
# attention block (projections + rope + residual-less core)
# ---------------------------------------------------------------------------
def attn_block(params, x, positions, theta, window=None, causal=True, impl="kernel"):
    """Self-attention.  x: (B, S, d). Returns (out, (k, v)) so callers can
    build caches."""
    q = constrain(project_heads(x, params["wq"]), "data", None, "model", None)
    q = apply_rope(q, positions, theta)
    k = apply_rope(project_heads(x, params["wk"]), positions, theta)
    v = project_heads(x, params["wv"])
    o = attention(q, k, v, positions, positions, window=window, causal=causal, impl=impl)
    return merge_heads(o, params["wo"]), (k, v)


def cross_attn_block(params, x, enc, impl="kernel"):
    """Cross-attention of the enc-dec decoder, the reference's ``attn_block``
    with ``kv_override``: queries from the decoder states x (B, S, d), keys
    and values from the encoder output enc (B, F, d), no RoPE on either side
    and no mask (Sq = S over Sk = F).  Returns (out, (xk, xv)), the encoder's
    K/V as the decode caches keep them."""
    q = constrain(project_heads(x, params["wq"]), "data", None, "model", None)
    k = project_heads(enc, params["wk"])
    v = project_heads(enc, params["wv"])
    o = attention(q, k, v, None, None, causal=False, impl=impl)
    return merge_heads(o, params["wo"]), (k, v)
