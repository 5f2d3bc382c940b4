"""Multi-head latent attention (MLA), as DeepSeek-V2/V3 and Kimi-K2 publish
it, with YaRN RoPE.

A layer's parameters, each stored (fan_in, fan_out) as the port's others:
``wq_a`` (d, q_lora), ``q_norm`` (q_lora,), ``wq_b`` (q_lora, H, dn + dr),
``wkv_a`` (d, kv_lora + dr), ``kv_norm`` (kv_lora,), ``wkv_b`` (kv_lora, H,
dn + dv) and ``wo`` (H, dv, d), where dn is ``qk_nope_head_dim``, dr
``qk_rope_head_dim`` and dv ``v_head_dim``.  A token's queries are
``q_b(norm(q_a(x)))``, [nope | rope] a head; ``kv_a(x)`` gives the latent
``c_kv`` (kv_lora, then normed) and one RoPE key ``k_pe`` (dr) that every
head shares; ``kv_b(c_kv)`` gives each head's [k_nope | v].

Prefill runs the non-absorbed form: keys [k_nope | k_pe] and values of every
head through K1 at head dims (dn + dr, dv) and YaRN's softmax scale.  The
cache keeps only ``c_kv`` (B, cap, kv_lora) and the roped ``k_pe`` (B, cap,
dr): 1152 bytes a token a layer in bf16 at Kimi-K2's widths.  Decode runs
the absorbed form in plain PyTorch (no kernel, no SDPA): the query's nope
part taken into the latent space through the key half of ``wkv_b``, scores
over the latent cache and the RoPE keys in f32, the probabilities times the
latent cache, brought back through the value half of ``wkv_b``.  It reads
the step's position from the device (``DecodeAt``), so a CUDA graph of the
step replays at any length.

While ``tracing.recording()`` is open, each layer's parts are spans inside
its ``attn`` span: ``mla.down`` (q_a, kv_a, the norms), ``mla.up`` (q_b and
kv_b, and RoPE, in prefill; the absorption and RoPE in decode),
``mla.attend`` (K1; the latent products and softmax in decode) and
``mla.out`` (the value half of ``wkv_b`` in decode, and ``wo``).

Latent attention on a mesh (DTensor parameters) is not supported.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def init_mla(gen: torch.Generator, cfg: ModelConfig):
    a, d, h, dt = cfg.mla, cfg.d_model, cfg.n_heads, cfg.dtype
    zeros = lambda n: torch.zeros((n,), dtype=dt, device=gen.device)  # noqa: E731
    return {
        "wq_a": L.init_dense(gen, d, a.q_lora_rank, dt),
        "q_norm": zeros(a.q_lora_rank),
        "wq_b": L.init_dense(gen, a.q_lora_rank, h * a.qk_head_dim, dt).view(
            a.q_lora_rank, h, a.qk_head_dim),
        "wkv_a": L.init_dense(gen, d, a.kv_lora_rank + a.qk_rope_head_dim, dt),
        "kv_norm": zeros(a.kv_lora_rank),
        "wkv_b": L.init_dense(gen, a.kv_lora_rank, h * (a.qk_nope_head_dim + a.v_head_dim),
                              dt).view(a.kv_lora_rank, h, a.qk_nope_head_dim + a.v_head_dim),
        "wo": L.init_dense(gen, h * a.v_head_dim, d, dt).view(h, a.v_head_dim, d),
    }


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device):
    a = cfg.mla
    return {"c_kv": torch.zeros((batch, capacity, a.kv_lora_rank), dtype=cfg.dtype,
                                device=device),
            "k_pe": torch.zeros((batch, capacity, a.qk_rope_head_dim), dtype=cfg.dtype,
                                device=device)}


def softmax_scale(cfg: ModelConfig) -> float:
    """qk_head_dim ** -0.5, times YaRN's mscale squared where
    ``mscale_all_dim`` is set (DeepSeek-V3's ``softmax_scale``)."""
    scale = cfg.mla.qk_head_dim ** -0.5
    y = cfg.rope_scaling
    if y is not None and y.mscale_all_dim:
        scale *= L.yarn_mscale(y.factor, y.mscale_all_dim) ** 2
    return scale


def _rope(x, positions, cfg: ModelConfig):
    """RoPE on the last dim (half-split pairs), with YaRN's frequencies and
    its cos/sin factor where the config scales."""
    y = cfg.rope_scaling
    if y is None:
        return L.apply_rope(x, positions, cfg.rope_theta)
    out = L.apply_rope(x, positions, cfg.rope_theta,
                       freqs=L.yarn_freqs(x.shape[-1], cfg.rope_theta, y, x.device))
    m = L.yarn_mscale(y.factor, y.mscale) / L.yarn_mscale(y.factor, y.mscale_all_dim)
    return out if m == 1.0 else (out.float() * m).to(x.dtype)


def _check_local(params):
    if isinstance(params["wq_a"], DTensor):
        raise NotImplementedError("latent attention (MLA) on a mesh is not supported: "
                                  "run it with plain tensors on one device")


def _down(params, x, cfg: ModelConfig):
    """x (B, S, d) -> (normed q latent (B, S, q_lora), normed c_kv (B, S,
    kv_lora), k_pe before RoPE (B, S, dr))."""
    a = cfg.mla
    with tracing.span("mla.down"):
        cq = L.rms_norm(x @ params["wq_a"], params["q_norm"], cfg.norm_eps)
        kv = x @ params["wkv_a"]
        c_kv = L.rms_norm(kv[..., :a.kv_lora_rank], params["kv_norm"], cfg.norm_eps)
        k_pe = kv[..., a.kv_lora_rank:]
    return cq, c_kv, k_pe


def prefill(params, x, positions, cfg: ModelConfig, capacity=None, impl="kernel"):
    """Self-attention over the prompt, causal.  x: (B, S, d).  Returns (out
    (B, S, d), cache {c_kv, k_pe} of ``capacity`` slots, the prompt's first,
    or {} when ``capacity`` is None (training))."""
    _check_local(params)
    a, h = cfg.mla, cfg.n_heads
    b, s, _ = x.shape
    cq, c_kv, k_pe = _down(params, x, cfg)
    with tracing.span("mla.up"):
        q = L.project_heads(cq, params["wq_b"])                    # (B, S, H, dn + dr)
        kvb = L.project_heads(c_kv, params["wkv_b"])              # (B, S, H, dn + dv)
        k_nope, v = kvb.split([a.qk_nope_head_dim, a.v_head_dim], dim=-1)
        q_nope, q_pe = q.split([a.qk_nope_head_dim, a.qk_rope_head_dim], dim=-1)
        q = torch.cat([q_nope, _rope(q_pe, positions, cfg)], dim=-1)
        k_pe = _rope(k_pe[:, :, None], positions, cfg)             # (B, S, 1, dr)
        k = torch.cat([k_nope, k_pe.expand(b, s, h, a.qk_rope_head_dim)], dim=-1)
        v = v.contiguous()
    with tracing.span("mla.attend"):
        o = L.attention(q, k, v, positions, positions, causal=True, impl=impl,
                        scale=softmax_scale(cfg))
    with tracing.span("mla.out"):
        out = L.merge_heads(o, params["wo"])
    cache = {}
    if capacity is not None:
        if capacity < s:
            raise ValueError(f"a prompt of {s} positions does not fit a latent cache of "
                             f"{capacity} slots; raise max_ctx or shorten the prompt")
        cache = init_cache(cfg, b, capacity, x.device)
        cache["c_kv"][:, :s] = c_kv
        cache["k_pe"][:, :s] = k_pe[:, :, 0]
    return out, cache


def decode(params, h, cache, at, cfg: ModelConfig):
    """One token a row in the absorbed form.  h: (B, 1, d); ``at`` the
    step's ``DecodeAt``.  Writes the token's latent and RoPE key into the
    cache in place at ``at.slot`` and attends over ``at.valid`` slots.
    Returns (out (B, 1, d), cache)."""
    _check_local(params)
    a = cfg.mla
    dn = a.qk_nope_head_dim
    cq, c1, kpe1 = _down(params, h, cfg)
    with tracing.span("mla.up"):
        q = L.project_heads(cq, params["wq_b"])                         # (B, 1, H, dn + dr)
        q_nope, q_pe = q[:, 0].split([dn, a.qk_rope_head_dim], dim=-1)
        q_pe = _rope(q_pe[:, None], at.pos, cfg)[:, 0]                 # (B, H, dr)
        kpe1 = _rope(kpe1[:, :, None], at.pos, cfg)[:, :, 0]           # (B, 1, dr)
        w_uk = params["wkv_b"][..., :dn]                                # (kv_lora, H, dn)
        q_lat = torch.einsum("bhn,chn->bhc", q_nope, w_uk)              # (B, H, kv_lora)
    cap = cache["c_kv"].shape[1]
    idx = at.slot(cap)
    if at.on_device:
        cache["c_kv"].index_copy_(1, idx, c1)
        cache["k_pe"].index_copy_(1, idx, kpe1)
    else:
        cache["c_kv"][:, idx] = c1[:, 0]
        cache["k_pe"][:, idx] = kpe1[:, 0]
    with tracing.span("mla.attend"):
        c_kv, k_pe = cache["c_kv"], cache["k_pe"]
        scores = (torch.einsum("bhc,blc->bhl", q_lat.float(), c_kv.float())
                  + torch.einsum("bhr,blr->bhl", q_pe.float(), k_pe.float()))
        scores = scores * softmax_scale(cfg)
        valid = torch.arange(cap, device=h.device)[None, :] < at.valid[:, None].clamp(max=cap)
        scores = torch.where(valid[:, None, :], scores, L.NEG_INF)
        p = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bhl,blc->bhc", p.to(c_kv.dtype), c_kv)   # (B, H, kv_lora)
    with tracing.span("mla.out"):
        w_uv = params["wkv_b"][..., dn:]                                # (kv_lora, H, dv)
        o = torch.einsum("bhc,chv->bhv", o_lat, w_uv)
        out = L.merge_heads(o[:, None], params["wo"])
    return out, cache
