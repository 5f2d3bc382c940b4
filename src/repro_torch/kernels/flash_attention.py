"""GQA prefill attention: the Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``) with ``csrc/flash_attention.cu``.
Like the TPU kernel it takes Sq queries over Sk keys, Sq != Sk included
(whisper's cross-attention prefill: the decoder's prompt over the encoder's
frames), causal (positions counted from 0 on both sides, so the mask keeps
``k_pos <= q_pos``), windowed or not.

What bounds it on an H100 (data-sheet rates at the card's 700 W power
limit): per (batch, head) the causal product does about S^2/2 * 4 * hd
FLOPs on 4 * S * hd elements of Q, K, V and O, about S / 4 FLOPs a byte in
bf16.  The card's ridge is about 295 FLOPs a byte (989 TFLOP/s bf16 over
3.35 TB/s), so at the decoders' prompt lengths (S = 8 to 512) the bound is
the bytes; it turns to the FLOPs only above S of about 1200 (whisper's
non-causal encoder at S 1500 does S / 2 FLOPs a byte).  A few queries over
many keys read K and V once a query tile: their bytes bound it.

The kernel is chosen by dtype, and each dtype has exactly one:

* bf16, the serving path: FlashAttention-2 on the tensor cores.  Eight
  warps a 128-query tile, 16 rows each, ``mma.sync`` m16n8k16 for Q K^T
  and for P V with the score fragment exponentiated in registers and fed
  back as P, K and V tiles bf16 in padded shared rows (ldmatrix without
  bank conflicts at hd 96 and 128) arriving by ``cp.async`` into a
  two-stage ring, so loads overlap products and two blocks share an SM.
  The loads and the per-tile work, not the tensor-core rate, are what
  separate it from its bound below S of about 1200; ``wgmma`` and TMA
  are the next step.
* f32, the reduced families the profiler measures and the f32 parity
  checks: products on the f32 CUDA cores, so f32 inputs are never rounded
  to TF32 (which would miss the reference's f32 tolerance of 2e-4).

Both never write the S x S scores to device memory (online softmax in
registers), read each K/V tile once per query tile, and skip the key tiles
that the causal mask or the window hides entirely.

Values may be narrower than queries and keys: latent attention's prefill
(MLA, Kimi-K2) attends with q and k of head dim 192 (128 without RoPE and
64 with it) and v of 128, at the softmax scale YaRN sets.  The kernels are
templated on the two head dims; ``HEAD_DIM_PAIRS`` lists the pairs
instantiated.

On a CPU tensor ``flash_attention`` computes the plain version; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 96, 128)
# (head dim of q and k, head dim of v)
HEAD_DIM_PAIRS = tuple((hd, hd) for hd in HEAD_DIMS) + ((192, 128),)
DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"want q (B,Sq,H,hd), k (B,Sk,KV,hd) and v (B,Sk,KV,hd_v); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "in batch or head_dim")
    if s == 0 or k.shape[1] == 0:
        raise ValueError(f"want Sq >= 1 and Sk >= 1; got {s} and {k.shape[1]}")
    if kv == 0 or h % kv:
        raise ValueError(f"KV heads ({kv}) must divide query heads ({h})")
    if (hd, v.shape[3]) not in HEAD_DIM_PAIRS:
        raise ValueError(f"head dims (q/k {hd}, v {v.shape[3]}) not in {HEAD_DIM_PAIRS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: want one of {DTYPES}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if q.device.type == "cuda" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary (the kernel "
                         "copies 16-byte pieces)")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1")


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, scale: Optional[float] = None):
    """The kernel's function in plain PyTorch, as ``repro.kernels.ref``
    computes it: f32 scores, ``-1e30`` mask over Sq x Sk, softmax,
    probabilities cast to V's type for the PV product."""
    b, sq, h, hd = q.shape
    group = h // k.shape[2]
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    scale = 1.0 / hd ** 0.5 if scale is None else scale
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qp = torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(k.shape[1], device=q.device)[None, :]
        ok = kp <= qp
        if window is not None:
            ok &= kp > qp - window
        scores = torch.where(ok, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


@functools.cache
def _function():
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, scale: Optional[float] = None):
    """q: (B, Sq, H, hd); k: (B, Sk, KV, hd); v: (B, Sk, KV, hd_v) with
    (hd, hd_v) in ``HEAD_DIM_PAIRS``, KV | H, Sq >= 1 and Sk >= 1.  Returns
    (B, Sq, H, hd_v) in q's dtype.  The scores are scaled by ``scale``, by
    default 1 / sqrt(hd).  Causal masking counts query and key positions
    from 0 alike and keeps ``k_pos <= q_pos``; ``window`` also keeps only
    ``k_pos > q_pos - window``.

    A CUDA tensor launches the tensor-core kernel for bf16 and the
    CUDA-core kernel for f32 (see the module's docstring), or raises."""
    _check(q, k, v, window)
    _build.refuse_autograd("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA, not {q.device}")
    lib, fn = _function()
    b, s, h, hd = q.shape
    hd_v = v.shape[3]
    o = q.new_empty((b, s, h, hd_v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 b, s, k.shape[1], h, k.shape[2], hd, hd_v, int(q.dtype == torch.bfloat16),
                 1.0 / hd ** 0.5 if scale is None else scale, int(causal), window or 0, stream)
    flash_attention.launches += 1
    _build.check(lib, err, "flash_attention")
    return o


flash_attention.launches = 0
