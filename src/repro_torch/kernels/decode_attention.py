"""One-token decode attention over a KV cache: the Hopper kernel and its
plain version.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention`` / ``_decode_kernel``) with ``csrc/decode_attention.cu``.

What bounds it on an H100 (data-sheet rates at the card's 700 W power
limit): bytes.  Each step reads the cache's valid slots, 2 * n * KV * hd
elements, for 4 * H * n * hd FLOPs, about 2 * group / itemsize FLOPs a byte,
far below the card's ridge of about 295 FLOPs a byte (989 TFLOP/s bf16 over
3.35 TB/s).  What the design
does about it: one block per (batch, KV head) holds the whole GQA group, so
each cache slot crosses from device memory once per step, and the block
reads only the slots the softmax needs (``min(lengths[b], L)``), not the
whole ring.  At the serving path's sizes (B = 4, a few hundred slots) the
grid is B * KV blocks, too few to fill 132 SMs; splitting the cache axis
across blocks (flash-decoding) is the next step.

On a CPU tensor ``decode_attention`` computes the plain version; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS, NEG_INF


def _check(q, k_cache, v_cache, lengths):
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"want q (B,H,hd) and caches (B,L,KV,hd); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, h, hd = q.shape
    kv = k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and cache {tuple(k_cache.shape)} disagree")
    if kv == 0 or h % kv:
        raise ValueError(f"KV heads ({kv}) must divide query heads ({h})")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k_cache.dtype}, {v_cache.dtype}: "
                         f"want one of {DTYPES}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 of shape ({b},); got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if not (q.device == k_cache.device == v_cache.device == lengths.device):
        raise ValueError("q, caches and lengths must be on one device")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, lengths)):
        raise ValueError("q, caches and lengths must be contiguous")


def decode_attention_plain(q, k_cache, v_cache, lengths):
    """The kernel's function in plain PyTorch, as ``repro.kernels.ref``
    computes it: slots at or past ``lengths[b]`` score ``-1e30``."""
    b, h, hd = q.shape
    L, kv = k_cache.shape[1], k_cache.shape[2]
    k = k_cache.repeat_interleave(h // kv, dim=2)
    v = v_cache.repeat_interleave(h // kv, dim=2)
    scores = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * (1.0 / hd ** 0.5)
    valid = torch.arange(L, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p.to(v.dtype), v)


@functools.cache
def _function():
    lib = _build.load("decode_attention")
    fn = lib.repro_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def decode_attention(q, k_cache, v_cache, lengths):
    """q: (B, H, hd); caches: (B, L, KV, hd); lengths: (B,) int32 valid
    slots.  Returns (B, H, hd) in q's dtype."""
    _check(q, k_cache, v_cache, lengths)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CPU or CUDA, not {q.device}")
    lib, fn = _function()
    b, h, hd = q.shape
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 lengths.data_ptr(), o.data_ptr(), b, k_cache.shape[1], h,
                 k_cache.shape[2], hd, int(q.dtype == torch.bfloat16),
                 1.0 / hd ** 0.5, stream)
    decode_attention.launches += 1
    _build.check(lib, err, "decode_attention")
    return o


decode_attention.launches = 0
