"""The plain reference of the decoder layout (``bench/layouts/decoder.py``),
in float32: dense GQA decoders (phi-3's text backbone, yi) and the hybrid
jamba with its Mamba2 mixer and its MoE layers, written from their
published equations and the configuration files.

Departures from the published models, as the configurations state them
(the program runs them so): the logits come from the tied embedding, and
jamba's mixer is Mamba2 (SSD) in place of Mamba-1.  Jamba's MoE layers
keep the program's capacity rule, which the configuration states: top-k
routing with the k weights renormalised, routing groups of
``moe_group_size`` tokens (one group where the tokens do not divide into
them), capacity ``int(factor * k * tokens / experts) + 1`` (at most the
group's tokens), slots taken token by token with k fastest, and a pair
past its expert's capacity dropped.  So the reference is handed each batch
as it was formed, and the segments in which its tokens were routed
together: the prompt, then each decoded position.

Nothing here imports the program, jax or the reference package ``repro``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.layouts.decoder import is_attn, is_moe, mamba_dims
from bench.reference.model import mm, rms_norm, rope


def attention(x, w, p, st, prec):
    r, t, _ = x.shape
    h, kv, hd = st["num_attention_heads"], st["num_key_value_heads"], st["head_dim"]
    q = rope(mm(x, w[p + "q_proj"], prec).view(r, t, h, hd), st["rope_theta"])
    k = rope(mm(x, w[p + "k_proj"], prec).view(r, t, kv, hd), st["rope_theta"])
    v = mm(x, w[p + "v_proj"], prec).view(r, t, kv, hd)
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    out = torch.empty(r, t, h, hd, device=x.device)
    for i in range(r):                      # one row's scores at a time
        s = torch.einsum("qhd,khd->hqk", q[i], k[i]) / hd ** 0.5
        s = s.masked_fill(~mask, float("-inf"))
        out[i] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v[i])
    return mm(out.reshape(r, t, h * hd), w[p + "o_proj"], prec)


def mlp(x, w, p, prec):
    return mm(F.silu(mm(x, w[p + "gate_proj"], prec)) * mm(x, w[p + "up_proj"], prec),
              w[p + "down_proj"], prec)


def _top_k(probs, k):
    """The k largest of each row, equal values in index order."""
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return top_w[:, :k], top_i[:, :k]


def kept(top_i, st):
    """Which of one routing group's (token, k) pairs (T, k) fit their
    expert's capacity, slots taken token by token with k fastest."""
    n, k = top_i.shape
    e = st["num_experts"]
    cap = max(min(int(st["capacity_factor"] * k * n / e) + 1, n), 1)
    onehot = F.one_hot(top_i.reshape(-1), e)
    slot = ((onehot.cumsum(0) - onehot) * onehot).sum(-1).view(n, k)
    return slot < cap


def _moe_group(xg, w, p, st, prec):
    """One routing group xg (T, d) -> (T, d)."""
    e, k = st["num_experts"], st["num_experts_per_tok"]
    probs = torch.softmax(mm(xg, w[p + "router"], prec), dim=-1)
    top_w, top_i = _top_k(probs, k)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    keep = kept(top_i, st)
    y = torch.zeros_like(xg)
    for j in range(e):
        tok, kk = torch.nonzero((top_i == j) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xg[tok]
        g = mm(xe, w[p + "experts.gate_proj"][j], prec)
        u = mm(xe, w[p + "experts.up_proj"][j], prec)
        ye = mm(F.silu(g) * u, w[p + "experts.down_proj"][j], prec)
        y.index_add_(0, tok, ye * top_w[tok, kk][:, None])
    return y


def moe(x, w, p, st, segments, prec):
    """x: (R, T, d); segments: the (start, end) positions routed together,
    each segment's tokens taken row by row."""
    y = torch.empty_like(x)
    d, gs = x.shape[-1], st["moe_group_size"]
    for a, b in segments:
        xs = x[:, a:b].reshape(-1, d)
        n = xs.shape[0]
        tg = min(gs, n)
        if n % tg:
            tg = n
        ys = torch.cat([_moe_group(xs[i:i + tg], w, p, st, prec) for i in range(0, n, tg)])
        y[:, a:b] = ys.view(x.shape[0], b - a, d)
    return y


def mamba(x, w, p, st, prec):
    """The Mamba2 mixer with the exact recurrence over every position."""
    r, t, _ = x.shape
    m = mamba_dims(st)
    din, gn, nh = m["d_inner"], m["gn"], m["heads"]
    hp, n, kc = st["mamba_head_dim"], st["mamba_d_state"], st["mamba_d_conv"]
    zxbcdt = mm(x, w[p + "in_proj"], prec)
    z, xbc, dt = zxbcdt[..., :din], zxbcdt[..., din:2 * din + 2 * gn], zxbcdt[..., 2 * din + 2 * gn:]
    cw, cb = w[p + "conv1d.weight"].float(), w[p + "conv1d.bias"].float()
    pad = F.pad(xbc, (0, 0, kc - 1, 0))
    xbc = F.silu(sum(pad[:, i:i + t] * cw[:, i] for i in range(kc)) + cb)
    xs = xbc[..., :din].reshape(r, t, nh, hp)
    bm = xbc[..., din:din + gn].reshape(r, t, -1, n)
    cm = xbc[..., din + gn:].reshape(r, t, -1, n)
    rep = nh // bm.shape[2]
    bm, cm = bm.repeat_interleave(rep, 2), cm.repeat_interleave(rep, 2)
    dt = torch.logaddexp(dt + w[p + "dt_bias"].float(), torch.zeros((), device=x.device))
    decay = torch.exp(dt * -torch.exp(w[p + "A_log"].float()))            # (R, T, H)
    state = torch.zeros(r, nh, hp, n, device=x.device)
    y = torch.empty(r, t, nh, hp, device=x.device)
    blk = 128
    for a in range(0, t, blk):
        b = min(a + blk, t)
        inp = torch.einsum("rthp,rthn->rthpn", xs[:, a:b] * dt[:, a:b, :, None], bm[:, a:b])
        for i in range(b - a):
            state = state * decay[:, a + i, :, None, None] + inp[:, i]
            y[:, a + i] = torch.einsum("rhpn,rhn->rhp", state, cm[:, a + i])
    y = y + w[p + "D"].float()[:, None] * xs
    y = y.reshape(r, t, din) * F.silu(z)
    y = rms_norm(y, w[p + "norm"], st["rms_norm_eps"])
    return mm(y, w[p + "out_proj"], prec)


def forward(w, st, batches, prompt_len: int, n_out: int, prec="f32"):
    """batches: a list of (R_b, T) id tensors, each a batch as the program
    formed it: the prompt of ``prompt_len`` then the tokens fed back one by
    one.  Attention and MoE see one batch at a time; the row-wise layers
    take every row at once.  Returns each batch's logits (R_b, n_out, V)
    of the last n_out positions."""
    eps = st["rms_norm_eps"]
    t = batches[0].shape[1]
    rows = [b.shape[0] for b in batches]
    segments = [(0, prompt_len)] + [(s, s + 1) for s in range(prompt_len, t)]
    x = w["embed_tokens"][torch.cat(batches)].float()
    for i in range(st["num_hidden_layers"]):
        p = f"layers.{i}."
        h = rms_norm(x, w[p + "input_layernorm"], eps)
        if is_attn(st, i):
            x = x + torch.cat([attention(hb, w, p + "self_attn.", st, prec)
                               for hb in h.split(rows)])
        else:
            x = x + mamba(h, w, p + "mamba.", st, prec)
        h = rms_norm(x, w[p + "post_attention_layernorm"], eps)
        if is_moe(st, i):
            x = x + torch.cat([moe(hb, w, p + "moe.", st, segments, prec)
                               for hb in h.split(rows)])
        else:
            x = x + mlp(h, w, p + "mlp.", prec)
    x = rms_norm(x[:, t - n_out:], w["norm"], eps)
    return list(mm(x, w["embed_tokens"].T, prec).split(rows))
