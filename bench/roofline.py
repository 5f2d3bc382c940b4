"""The yardstick's arithmetic: the H100's data-sheet peaks and each
kernel's least time from its shapes.

``flash_bound``, ``decode_bound`` and ``ssd_bound`` are frozen copies of
``chip_smoke.py``'s, which count operations and bytes from shapes alone:
whatever implements a kernel later, its roofline is read against the same
counts.  Each returns the least time in ms and which bound binds.

Each layout (``bench/layouts/<layout>.py``) counts from a stage's
configuration with these:

- ``batch_flops(st, b, prompt, gen)``: what one served batch of ``b`` rows
  needs: the prompt through every layer, the last prompt position's
  logits, and ``gen - 1`` decode positions (the last generated token is
  never fed back).  Products with weights count 2 FLOPs a multiply-add,
  attention its scores and values over the keys each position sees.
  Norms, RoPE, softmax and other elementwise work are left out.
- ``kernel_bounds(st, b, prompt, gen)``: the summed least time (ms) of
  every call of each kernel role that batch makes, by role; a role the
  layout does not call is absent (``bench/metrics/_kernel_share.py`` reads
  it as 0).
"""
from __future__ import annotations

import functools

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
ITEM = {"bf16": 2, "f32": 4}


def _bound(flops, nbytes, dtype):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


@functools.lru_cache(maxsize=None)
def flash_bound(b, sq, sk, h, kv, hd, dtype, window=None, causal=True):
    """Operations over the (query, key) pairs the mask keeps (causal: keys
    0..q, and past q - window; a row that keeps none weighs every key);
    bytes: Q and O over Sq, K and V over Sk."""
    def keys(q):
        if not causal:
            return sk
        n = min(q + 1, sk) - (max(0, q - window + 1) if window else 0)
        return n if n > 0 else sk
    pairs = sum(keys(q) for q in range(sq))
    flops = 4.0 * b * h * hd * pairs
    nbytes = (2 * b * sq * h * hd + 2 * b * sk * kv * hd) * ITEM[dtype]
    return _bound(flops, nbytes, dtype)


def decode_bound(h, kv, hd, L, lengths, dtype):
    slots = sum(min(n, L) if n > 0 else L for n in lengths)
    b = len(lengths)
    flops = 4.0 * h * hd * slots
    nbytes = (2 * b * h * hd + 2 * kv * hd * slots) * ITEM[dtype] + 4 * b
    return _bound(flops, nbytes, dtype)


def ssd_bound(b, s, h, p, g, n, chunk, dtype):
    """Bytes: x, dt, a_neg, B and C read once, y and the f32 final state
    written once.  Operations: C.B^T once per (batch, chunk, group) and the
    per-head products, each over the lower triangle of a chunk's valid rows
    only."""
    item = ITEM[dtype]
    nbytes = 2 * b * s * h * p * item + 4 * b * s * h + 4 * h + 2 * b * s * g * n * item \
        + 4 * b * h * p * n
    flops = 0.0
    for c0 in range(0, s, chunk):
        rows = min(chunk, s - c0)
        pairs = rows * (rows + 1) / 2
        flops += b * (2.0 * pairs * n * g + h * (2.0 * pairs * p + 4.0 * rows * p * n))
    return _bound(flops, nbytes, dtype)
