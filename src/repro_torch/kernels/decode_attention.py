"""One-token decode attention over a KV cache: the Hopper kernel and its
plain version.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention`` / ``_decode_kernel``) with ``csrc/decode_attention.cu``.

What bounds it on an H100 (data-sheet rates at the card's 700 W power
limit): bytes.  Each step reads the cache's valid slots, 2 * n * KV * hd
elements, for 4 * H * n * hd FLOPs, about 2 * group / itemsize FLOPs a byte,
far below the card's ridge of about 295 FLOPs a byte (989 TFLOP/s bf16 over
3.35 TB/s).  What the design does about it: each block streams its slots in
16-byte ``cp.async`` copies through a ring of up to four 64-slot stages,
the first ones issued before ``lengths`` has arrived, so that it pays the
latency of device memory about once; it holds the whole GQA group, so each
slot crosses from device memory once per step, and computes only the slots
below ``min(lengths[b], L)``.  Where B * KV leaves SMs idle the cache axis
is split across blocks ("flash-decoding"): the splits' f32 partials are
combined inside the same launch by the last block of each (batch, KV head)
to finish, counted on an int32 arrival counter.  bf16 runs its products on
the tensor cores (``mma.sync``, the GQA group padded to 16 rows) at every
group, phi-3's group of 1 included: fewer instructions per element than the
CUDA cores; f32 runs on the CUDA cores, so it is never rounded.

``split_plan`` chooses the split from (B, KV, L) alone: nothing is read
back from ``lengths``.  On a CPU tensor ``decode_attention`` computes the
plain version; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS, NEG_INF

# A split's slots are a multiple of SPLIT_SLOTS (the kernels' tile).  The
# splits aim at no more than TARGET_BLOCKS blocks, one on each of an H100's
# 132 SMs: each block keeps up to four 64-slot stages in flight, and a split
# costs a combine at the end, so at phi-3's decode shape one split (128
# blocks) measured faster than 2, 3 or 5 (PERF.md).
SPLIT_SLOTS = 64
TARGET_BLOCKS = 132


def split_plan(b: int, kv: int, L: int):
    """``(splits, chunk)`` for a cache of L slots: split s reads slots
    ``[s * chunk, (s + 1) * chunk)``.  chunk is a multiple of SPLIT_SLOTS,
    every split starts inside the cache, and together they cover it."""
    tiles = -(-L // SPLIT_SLOTS)
    splits = max(1, min(tiles, TARGET_BLOCKS // (b * kv)))
    per = -(-tiles // splits)
    return -(-tiles // per), per * SPLIT_SLOTS


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
    if q.device.type == "cuda" and any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("q and the caches must start on a 16-byte boundary (the "
                         "kernel copies 16-byte pieces)")


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
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


# (device index, stream) -> int32 arrival counters, zero between launches:
# the block that combines a (batch, KV head) resets its counter, and one
# stream runs its launches in order.  At least 4096 of them, so that the
# serving shapes never grow the buffer (growing it zeroes a new one).
_counters = {}


def _counter_buffer(device, stream: int, n: int):
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def decode_attention(q, k_cache, v_cache, lengths):
    """q: (B, H, hd); caches: (B, L, KV, hd); lengths: (B,) int32 valid
    slots.  Returns (B, H, hd) in q's dtype."""
    _check(q, k_cache, v_cache, lengths)
    _build.refuse_autograd("decode_attention", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CPU or CUDA, not {q.device}")
    lib, fn = _function()
    b, h, hd = q.shape
    L, kv = k_cache.shape[1], k_cache.shape[2]
    splits, chunk = split_plan(b, kv, L)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws = (torch.empty(b * h * splits * (hd + 2), dtype=torch.float32, device=q.device)
              if splits > 1 else None)
        counters = _counter_buffer(q.device, stream, b * h)
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 lengths.data_ptr(), o.data_ptr(), None if ws is None else ws.data_ptr(),
                 counters.data_ptr(), b, L, h, kv, hd, int(q.dtype == torch.bfloat16),
                 1.0 / hd ** 0.5, splits, chunk, stream)
    decode_attention.launches += 1
    _build.check(lib, err, "decode_attention")
    return o


decode_attention.launches = 0
