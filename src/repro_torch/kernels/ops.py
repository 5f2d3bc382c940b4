"""Public wrappers around the Hopper kernels, with the call signatures of
``repro/kernels/ops.py``.

A CPU tensor runs the kernel's plain PyTorch version and a CUDA tensor
launches the kernel; there is no interpret mode and no switch between the
two.  ``q_pos``/``k_pos`` and the block sizes are accepted so that callers
of the reference run unchanged: the reference wrapper ignores the positions
too, and the CUDA kernels tile with the fixed 64-row tiles they were written
for.  ``ssd_scan`` does not cap the chunk at S as the reference wrapper
does: the kernel masks the ragged tail, so S need not be a multiple of the
chunk.  ``moe_experts`` has no counterpart in the reference, whose experts
are einsums: the port's MoE layer calls it at decode shapes.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_experts as _moe
from repro_torch.kernels import ssd_scan as _ssd


def flash_attention(q, k, v, q_pos=None, k_pos=None, *, causal: bool = True,
                    window: Optional[int] = None, block_q: int = 128,
                    block_k: int = 128, scale: Optional[float] = None):
    """Signature-compatible with repro_torch.models.layers.attention."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale)


def decode_attention(q, k_cache, v_cache, lengths, *, block_k: int = 128):
    return _dec.decode_attention(q, k_cache, v_cache, lengths)


def ssd_scan(x, dt, a_neg, b_mat, c_mat, *, chunk: int = 256, init_state=None):
    return _ssd.ssd_scan(x, dt, a_neg, b_mat, c_mat, chunk=chunk,
                         init_state=init_state)


def moe_experts(x, counts, w_in, w_gate, w_out):
    """The products of the experts whose count is above 0, zeros for the
    others: x (E, R, d), counts (E,) int32, w_in / w_gate (E, d, f), w_out
    (E, f, d); w_gate None for tanh-GELU experts."""
    return _moe.moe_experts(x, counts, w_in, w_gate, w_out)
