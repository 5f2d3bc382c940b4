"""The yardstick's arithmetic: the H100's data-sheet peaks, each kernel's
least time from its shapes, and the model FLOPs a served batch needs.

``flash_bound``, ``decode_bound`` and ``ssd_bound`` are frozen copies of
``chip_smoke.py``'s, which count operations and bytes from shapes alone:
whatever implements a kernel later, its roofline is read against the same
counts.  Each returns the least time in ms and which bound binds.

``batch_flops`` counts what one served batch of a stage needs, from the
configuration: the prompt through every layer, the last prompt position's
logits, and ``gen - 1`` decode positions (the last generated token is never
fed back).  Products with weights count 2 FLOPs a multiply-add; attention
counts QK^T and PV over the keys each position sees; the Mamba2 scan counts
its recurrent form (state update and read-out, 4 H P N a token); a MoE
layer counts its router and the top-k experts of each token.  Norms,
RoPE, softmax and other elementwise work are left out.
"""
from __future__ import annotations

import functools

from bench import spec

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


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------
def _layer_flops(st: dict, i: int, keys: int) -> float:
    """One token through layer i, attending over ``keys`` positions."""
    d = st["hidden_size"]
    f = 0.0
    if spec.is_attn(st, i):
        h, kv, hd = st["num_attention_heads"], st["num_key_value_heads"], st["head_dim"]
        f += 2.0 * d * (h + 2 * kv) * hd + 2.0 * h * hd * d + 4.0 * h * hd * keys
    else:
        m = spec.mamba_dims(st)
        din, nh = m["d_inner"], m["heads"]
        f += 2.0 * d * (2 * din + 2 * m["gn"] + nh) + 2.0 * din * d
        f += 2.0 * m["conv_dim"] * st["mamba_d_conv"]
        f += 4.0 * nh * st["mamba_head_dim"] * st["mamba_d_state"]
    if spec.is_moe(st, i):
        f += 2.0 * d * st["num_experts"]
        f += st["num_experts_per_tok"] * 6.0 * d * st["expert_intermediate_size"]
    else:
        f += 6.0 * d * st["intermediate_size"]
    return f


def token_flops(st: dict, keys: int) -> float:
    """One token through every layer at context ``keys``, no logits."""
    return sum(_layer_flops(st, i, keys) for i in range(st["num_hidden_layers"]))


def batch_flops(st: dict, b: int, prompt: int, gen: int) -> float:
    """token_flops is linear in the keys, so the sums over positions are
    taken in closed form."""
    head = 2.0 * st["hidden_size"] * st["vocab_size"]
    base = token_flops(st, 0)
    per_key = token_flops(st, 1) - base
    pre = prompt * base + per_key * prompt * (prompt + 1) / 2 + head
    keys = sum(prompt + j + 1 for j in range(gen - 1))
    dec = (gen - 1) * (base + head) + per_key * keys
    return b * (pre + dec)


# ---------------------------------------------------------------------------
# the port's kernel calls a served batch makes, from the configuration
# ---------------------------------------------------------------------------
def kernel_bounds(st: dict, b: int, prompt: int, gen: int) -> dict:
    """Least time (ms) of every K1, K2 and K3 call one batch of a stage
    makes: K1 once a attention layer over the prompt, K2 once a attention
    layer in each of ``gen`` decode steps over a cache of prompt + gen
    slots, K3 once a Mamba2 layer over the prompt."""
    out = {"attn_prefill": 0.0, "attn_decode": 0.0, "ssd": 0.0}
    cap = prompt + gen
    for i in range(st["num_hidden_layers"]):
        if spec.is_attn(st, i):
            h, kv, hd = st["num_attention_heads"], st["num_key_value_heads"], st["head_dim"]
            out["attn_prefill"] += flash_bound(b, prompt, prompt, h, kv, hd, "bf16")[0]
            for j in range(gen):
                out["attn_decode"] += decode_bound(h, kv, hd, cap, [prompt + j + 1] * b,
                                                   "bf16")[0]
        else:
            m = spec.mamba_dims(st)
            out["ssd"] += ssd_bound(b, prompt, m["heads"], st["mamba_head_dim"],
                                    st["mamba_n_groups"], st["mamba_d_state"],
                                    st["mamba_chunk_size"], "bf16")[0]
    return out
