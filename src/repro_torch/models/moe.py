"""Mixture-of-Experts layer: top-k routing with capacity, after
``repro/models/moe.py``.

Two dispatch implementations, as in the reference:

  * ``einsum`` -- one-hot dispatch/combine einsums (GShard/Switch style);
    the dispatch einsum costs T*E*C*d multiply-adds;
  * ``gather`` -- index-based dispatch (a gather into token-major slots and
    a gather back out): pure data movement, no dispatch products.

Capacity is set per routing group of ``GROUP_SIZE`` tokens (one group when
T is not a multiple of it), and a (token, expert) pair past its expert's
capacity is dropped, so the tokens of one batch change each other's
outputs (ROADMAP R5): the port reproduces that in both modes.  Numerics
follow the reference: router logits, softmax and the balancing loss in
f32 (the router parameter is f32 even in a bf16 model), the one-hots, the
combine and gather weights in the activation dtype, ties in top-k broken
towards the lower expert index as ``jax.lax.top_k`` does.  No kernel: the
expert products are plain batched matmuls, as XLA's are in the reference.
While ``tracing.recording()`` is open, routing, dispatch, the experts and
the combine are spans, and the pairs routed and dropped are counted.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import MoEConfig
from repro_torch.distributed.api import constrain, einsum
from repro_torch.models import layers as L

# routing-group tokens: capacity (and the dispatch tensor) is per group.  The
# reference's default (its REPRO_MOE_GROUP unset); ``group_size`` of
# ``moe_apply`` takes another.
GROUP_SIZE = 4096


def init_moe(gen: torch.Generator, d_model: int, mcfg: MoEConfig, gated: bool, dtype):
    """Random parameters with the reference's distributions, drawn in its
    order from ``gen`` on ``gen.device``."""
    p = {
        "router": L.init_dense(gen, d_model, mcfg.n_experts, torch.float32),
        "w_in": _init_experts(gen, mcfg.n_experts, d_model, mcfg.d_ff_expert, dtype),
        "w_out": _init_experts(gen, mcfg.n_experts, mcfg.d_ff_expert, d_model, dtype),
    }
    if gated:
        p["w_gate"] = _init_experts(gen, mcfg.n_experts, d_model, mcfg.d_ff_expert, dtype)
    if mcfg.n_shared_experts:
        p["shared"] = L.init_mlp(gen, d_model, mcfg.d_ff_shared, gated, dtype)
    return p


def _init_experts(gen, e, d_in, d_out, dtype):
    w = torch.randn((e, d_in, d_out), generator=gen, dtype=torch.float32, device=gen.device)
    return (w * (1.0 / d_in ** 0.5)).to(dtype)


def _capacity(n_tokens: int, mcfg: MoEConfig) -> int:
    c = int(mcfg.capacity_factor * mcfg.top_k * n_tokens / mcfg.n_experts) + 1
    return max(min(c, n_tokens), 1)


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: an index outside [0, n) gives an all-zero row
    (that is how pairs past capacity drop out of the einsum dispatch)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, equal values
    in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params, xf, mcfg: MoEConfig):
    """xf: (..., T, d) -> (top_w (..., T, k), top_i (..., T, k), aux_loss),
    the switch balancing loss of each (...,) group of T tokens."""
    probs = torch.softmax(xf.float() @ params["router"], dim=-1)   # (..., T, E)
    top_w, top_i = _top_k(probs, mcfg.top_k)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    me = probs.mean(dim=-2)                                         # (..., E)
    ce = _one_hot(top_i, mcfg.n_experts, torch.float32).sum(dim=-2).mean(dim=-2)
    aux = mcfg.n_experts * (me * ce).sum(dim=-1) * mcfg.router_aux_weight
    return top_w, top_i, aux


def _expert_ffn(params, xd):
    """xd: (..., E, C, d) -> (..., E, C, d) via each expert's (Sw)iGLU, or
    its tanh-GELU MLP where the experts are not gated: one batched product
    an expert over the rows of every group, as the reference's einsums
    contract them (a broadcast matmul would copy each expert's weights once
    for every routing group)."""
    *lead, e, c, d = xd.shape
    xe = xd.movedim(-3, 0).reshape(e, -1, d)                       # (E, ...*C, d)
    h = torch.bmm(xe, params["w_in"])
    if "w_gate" in params:
        h = F.silu(torch.bmm(xe, params["w_gate"])) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, params["w_out"]).reshape(e, *lead, c, d).movedim(0, -3)


def moe_apply(params, x, mcfg: MoEConfig, impl: str = "einsum",
              group_size: int = GROUP_SIZE):
    """x: (B, S, d). Returns (y (B, S, d), aux_loss 0-d f32)."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    tg = min(group_size, t)
    if t % tg != 0:
        tg = t          # irregular small inputs: one group
    g = t // tg
    cap = _capacity(tg, mcfg)
    xg = constrain(xf.reshape(g, tg, d), "data", None, None)

    if impl == "einsum":
        with tracing.span("moe.route"):
            top_w, top_i, aux = _route(params, xg, mcfg)
            aux = aux.mean()
        with tracing.span("moe.dispatch"):
            pos = _positions_in_expert_grouped(top_i, mcfg, cap)    # (G, Tg, k)
            _count_routing(pos, cap)
            e_oh = _one_hot(top_i, mcfg.n_experts, x.dtype)
            c_oh = _one_hot(pos, cap, x.dtype)
            combine = einsum("gtke,gtkc,gtk->gtec", e_oh, c_oh, top_w.to(x.dtype))
            dispatch = einsum("gtke,gtkc->gtec", e_oh, c_oh)
            # on a mesh, the one-hots and the experts' outputs in the reference's
            # expert-parallel layout (groups over data, experts over model):
            # DTensor, left to itself, shards the capacity dim of the combine
            # einsum's operands, which its flattening cannot do unevenly
            combine = constrain(combine, "data", None, "model", None)
            dispatch = constrain(dispatch, "data", None, "model", None)
            xd = constrain(einsum("gtec,gtd->gecd", dispatch, xg), "data", "model", None, None)
        with tracing.span("moe.experts"):
            ye = constrain(_expert_ffn(params, xd), "data", "model", None, None)
        with tracing.span("moe.combine"):
            y = constrain(einsum("gecd,gtec->gtd", ye, combine), "data", None, None).reshape(t, d)
            y = _add_shared(params, y, xf)
    elif impl == "gather":
        ys, auxs = [], []
        for xr in xg:
            with tracing.span("moe.route"):
                top_w, top_i, aux_g = _route(params, xr, mcfg)
            ys.append(_dispatch_gather(params, xr, top_w, top_i, mcfg, cap))
            auxs.append(aux_g)
        y = torch.cat(ys)
        aux = torch.stack(auxs).mean()
        if "shared" in params:
            with tracing.span("moe.combine"):
                y = _add_shared(params, y, xf)
    else:
        raise ValueError(f"unknown moe impl {impl!r}")
    return y.reshape(b, s, d), aux


def _add_shared(params, y, xf):
    """y plus the shared experts' output, where the layer has them."""
    if "shared" not in params:
        return y
    # on a mesh, the shared experts' partial sums reduced onto y's layout
    # (tokens over data): DTensor would otherwise scatter the tokens over
    # the model axis too, which the reshape back to (B, S, d) cannot split
    return y + constrain(L.mlp(params["shared"], xf), "data", None)


def _count_routing(pos, cap: int):
    """The (token, expert) pairs routed (a host count) and those past their
    expert's capacity, which are dropped (R5; on the device)."""
    tracing.count("moe.pairs", pos.numel())
    tracing.count_device("moe.dropped", pos, at_least=cap)


def _positions_in_expert_grouped(top_i, mcfg: MoEConfig, cap: int):
    """(G, Tg, k) slot indices within each group's expert buffers."""
    g, t, k = top_i.shape
    return _positions_in_expert(top_i.reshape(g, t * k, 1), mcfg, cap).reshape(g, t, k)


def _positions_in_expert(top_i, mcfg: MoEConfig, cap: int):
    """Slot of each (token, k) pair inside its expert's capacity buffer,
    counting pairs token-major with k fast over the last two axes of
    ``top_i`` (..., T, k).  Overflowing pairs get pos >= cap (dropped by
    the one-hot / scatter downstream)."""
    *lead, t, k = top_i.shape
    oh = _one_hot(top_i.reshape(*lead, t * k), mcfg.n_experts, torch.int32)
    pos = torch.cumsum(oh, dim=-2) - oh                            # exclusive prefix count
    return (pos * oh).sum(dim=-1).reshape(*lead, t, k)


def _dispatch_gather(params, xf, top_w, top_i, mcfg, cap):
    """Index-based dispatch: no O(T*E*C*d) dispatch products."""
    t, d = xf.shape
    e, k = mcfg.n_experts, mcfg.top_k
    with tracing.span("moe.dispatch"):
        pos = _positions_in_expert(top_i, mcfg, cap)               # (T, k)
        _count_routing(pos, cap)
        keep = pos < cap
        flat_e = top_i.reshape(-1)
        flat_c = torch.clamp(pos.reshape(-1), max=cap - 1)
        # token id occupying slot (e, c); `t` indexes a zero row for empty slots
        tok_ids = torch.arange(t, device=xf.device).repeat_interleave(k)
        upd = torch.where(keep.reshape(-1), tok_ids, t)
        gidx = flat_e * cap + flat_c
        slot_token = torch.full((e * cap,), t, dtype=torch.int64, device=xf.device)
        slot_token.scatter_reduce_(0, gidx, upd, reduce="amin", include_self=True)
        xz = torch.cat([xf, xf.new_zeros((1, d))])
        xe = xz[slot_token].reshape(e, cap, d)
    with tracing.span("moe.experts"):
        ye = _expert_ffn(params, xe)                               # (E, C, d)
    with tracing.span("moe.combine"):
        # gather each (token, k) pair's slot output, weight, and sum
        yk = ye.reshape(e * cap, d)[gidx].reshape(t, k, d)
        w = torch.where(keep, top_w, 0.0).to(xf.dtype)
        return torch.einsum("tkd,tk->td", yk, w)
