"""The plain reference of the latent-attention layout (``bench/layouts/mla.py``,
Kimi-K2-Instruct), in float32, written from DeepSeek-V3's published
modelling code and the configuration file:

- multi-head latent attention in its non-absorbed form: queries
  ``q_b(norm(q_a(x)))``, [nope | rope] a head; ``kv_a(x)`` splits into the
  latent (normed) and one RoPE key that every head shares; ``kv_b`` of the
  latent gives each head's [k_nope | v]; causal softmax attention at the
  scale ``qk_head_dim ** -0.5 * mscale(factor, mscale_all_dim) ** 2``, one
  row and one block of ``QUERY_BLOCK`` queries at a time (so 8192
  positions of 64 heads fit);
- YaRN RoPE as DeepSeek-V3's ``DeepseekV3YarnRotaryEmbedding`` computes it:
  the frequencies past the correction range divided by ``factor``, a
  linear ramp inside it, cos and sin times ``mscale(factor, mscale) /
  mscale(factor, mscale_all_dim)``;
- a SwiGLU MLP in the first ``first_k_dense_replace`` layers; after them
  sigmoid scores over all of the router's experts, the top-k by score plus
  ``e_score_correction_bias``, weighted by the chosen scores over their sum
  (+1e-20) times ``routed_scaling_factor`` (one group: ``n_group`` and
  ``topk_group`` 1), every pair computed (no capacity), the stage's held
  experts only, and the shared experts in full.

Departures from the published model, as the configuration states them (the
program runs them so): the logits come from the tied embedding; RoPE pairs
are half-split (with seeded weights, the published interleaved pairs are a
fixed permutation of the rope columns); equal selection scores are taken
in expert order; the routed experts of other expert-parallel ranks are left
out, as the stage leaves them out.

Nothing here imports the program, jax or the reference package ``repro``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.layouts.mla import dims, held, is_moe
from bench.reference.model import mm, rms_norm

QUERY_BLOCK = 1024


def mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def inv_freq(st: dict, device) -> torch.Tensor:
    """YaRN's inverse frequencies over the rope head dim."""
    dim, base, rs = st["qk_rope_head_dim"], float(st["rope_theta"]), st["rope_scaling"]
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    extra, inter = 1.0 / pos_freqs, 1.0 / (rs["factor"] * pos_freqs)

    def corr_dim(rot):
        return (dim * math.log(rs["original_max_position_embeddings"] / (rot * 2 * math.pi))
                / (2 * math.log(base)))
    low = max(math.floor(corr_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(corr_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    extra_mask = 1.0 - ramp
    return inter * (1 - extra_mask) + extra * extra_mask


def softmax_scale(st: dict) -> float:
    m = dims(st)
    rs = st["rope_scaling"]
    scale = (m["dn"] + m["dr"]) ** -0.5
    if rs.get("mscale_all_dim"):
        scale *= mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return scale


def rope(x, st):
    """x: (T, heads, dr) at positions 0..T-1, half-split pairs."""
    rs = st["rope_scaling"]
    ang = torch.arange(x.shape[0], dtype=torch.float32, device=x.device)[:, None] \
        * inv_freq(st, x.device)
    m = mscale(rs["factor"], rs["mscale"]) / mscale(rs["factor"], rs["mscale_all_dim"])
    sin, cos = torch.sin(ang)[:, None] * m, torch.cos(ang)[:, None] * m
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x, w, p, st, prec):
    """One row x (T, d) -> (T, d)."""
    t = x.shape[0]
    m = dims(st)
    h, kvl, dn, dr, dv = m["h"], m["kvl"], m["dn"], m["dr"], m["dv"]
    eps = st["rms_norm_eps"]
    q = mm(rms_norm(mm(x, w[p + "q_a_proj"], prec), w[p + "q_a_layernorm"], eps),
           w[p + "q_b_proj"], prec).view(t, h, dn + dr)
    kv = mm(x, w[p + "kv_a_proj_with_mqa"], prec)
    c = rms_norm(kv[:, :kvl], w[p + "kv_a_layernorm"], eps)
    k_pe = rope(kv[:, None, kvl:], st)                                  # (T, 1, dr)
    kvb = mm(c, w[p + "kv_b_proj"], prec).view(t, h, dn + dv)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], st)], dim=-1)
    k = torch.cat([kvb[..., :dn], k_pe.expand(t, h, dr)], dim=-1)
    v = kvb[..., dn:]
    scale = softmax_scale(st)
    out = torch.empty(t, h, dv, device=x.device)
    for a in range(0, t, QUERY_BLOCK):
        b = min(a + QUERY_BLOCK, t)
        s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * scale
        mask = torch.arange(b, device=x.device)[None, :] > torch.arange(a, b, device=x.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v[:b])
    return mm(out.reshape(t, h * dv), w[p + "o_proj"], prec)


def mlp(x, w, p, prec):
    return mm(F.silu(mm(x, w[p + "gate_proj"], prec)) * mm(x, w[p + "up_proj"], prec),
              w[p + "down_proj"], prec)


def route(x, w, p, st, prec):
    """x: (N, d) -> (top_w (N, k), top_i (N, k)) over the router's experts."""
    scores = torch.sigmoid(mm(x, w[p + "gate"], prec))
    sel = scores + w[p + "gate.e_score_correction_bias"].float()
    _, top_i = torch.sort(sel, dim=-1, descending=True, stable=True)
    top_i = top_i[:, :st["num_experts_per_tok"]]
    top_w = scores.gather(-1, top_i)
    top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20) * st["routed_scaling_factor"]
    return top_w, top_i


def moe(x, w, p, st, prec):
    """x: (N, d) -> (N, d): the held experts' part and the shared experts."""
    top_w, top_i = route(x, w, p, st, prec)
    first, n_held = held(st)
    y = mlp(x, w, p + "shared_experts.", prec)
    for j in range(n_held):
        tok, kk = torch.nonzero(top_i == first + j, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        g = mm(xe, w[p + "experts.gate_proj"][j], prec)
        u = mm(xe, w[p + "experts.up_proj"][j], prec)
        ye = mm(F.silu(g) * u, w[p + "experts.down_proj"][j], prec)
        y.index_add_(0, tok, ye * top_w[tok, kk][:, None])
    return y


def forward(w, st, batches, prompt_len: int, n_out: int, prec="f32"):
    """batches: a list of (R_b, T) id tensors (a prompt of ``prompt_len``
    then the tokens fed back one by one).  Every row is independent here:
    attention sees one row, and dropless routing makes each token's experts
    its own.  Returns each batch's logits (R_b, n_out, V) of the last n_out
    positions."""
    eps = st["rms_norm_eps"]
    rows = [b.shape[0] for b in batches]
    ids = torch.cat(batches)
    r, t = ids.shape
    x = w["embed_tokens"][ids].float()
    for i in range(st["num_hidden_layers"]):
        p = f"layers.{i}."
        h = rms_norm(x, w[p + "input_layernorm"], eps)
        x = x + torch.stack([attention(hr, w, p + "self_attn.", st, prec) for hr in h])
        h = rms_norm(x, w[p + "post_attention_layernorm"], eps).view(r * t, -1)
        if is_moe(st, i):
            x = x + moe(h, w, p + "mlp.", st, prec).view(r, t, -1)
        else:
            x = x + mlp(h, w, p + "mlp.", prec).view(r, t, -1)
    x = rms_norm(x[:, t - n_out:], w["norm"], eps)
    return list(mm(x, w["embed_tokens"].T, prec).split(rows))
