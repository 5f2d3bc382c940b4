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

A layer whose ``MoEConfig.router`` is ``"sigmoid"`` (DeepSeek-V3's
``noaux_tc``, Kimi-K2) routes otherwise: f32 sigmoid scores over all
``n_experts``, the top-k chosen by score plus the layer's f32 selection
bias, weighted by the chosen unbiased scores over their sum (+1e-20) times
``routed_scale``; no capacity, so nothing is dropped and a token's output
does not depend on the rest of the batch; no balancing loss.  Such a layer
holds the experts of one expert-parallel rank (``MoEConfig.first_held``
on, ``n_held`` of them) and computes only their part of the result, the
pairs routed to them; its shared expert is added in full.  Prefill sorts
the held pairs by expert and runs each expert over its own tokens (the
per-expert counts are read on the host); a decode step, which a CUDA graph
captures and which may not wait on the host, gives every held expert the
step's few rows, those not routed to it zeroed, and weighs its outputs by
the pairs routed to it (``static``).  Besides ``moe.pairs`` (every routed
pair, on the host) it counts ``moe.held``, the pairs routed to a held
expert, on the device.

With ``expert_impl="kernel"`` (``layer_apply``'s ``impl``), where an
expert gets at most ``moe_experts.ROW_LIMIT`` rows (the einsum dispatch's
capacity times its groups, or a static step's rows: decode shapes), the
inputs are plain tensors that need no gradient, and the kernel takes their
type on their device, the expert products go to
``kernels.ops.moe_experts``, which reads the weights of the experts that
hold a row only and gives the others exact zeros; the count of each
expert's rows is made on the device from the routing (the kept slots of
``dispatch``, or the routed rows), so a captured decode step follows each
replay's routing.  An expert with no row contributes zero either way: the
experts have no bias, so zero rows give zero outputs, and the combine
weighs them by zero.  Elsewhere (prefill, a mesh, the gather dispatch,
training, another ``expert_impl``: the naive path stays the reference)
the batched products run over every expert.  Such a call counts
``moe.experts`` (the experts it was given, on the host) and
``moe.experts_read`` (those holding a row, on the device).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch import tracing
from repro_torch.configs.base import MoEConfig
from repro_torch.distributed.api import constrain, einsum
from repro_torch.kernels import moe_experts as KX
from repro_torch.kernels import ops as KO
from repro_torch.models import layers as L

# routing-group tokens: capacity (and the dispatch tensor) is per group.  The
# reference's default (its REPRO_MOE_GROUP unset); ``group_size`` of
# ``moe_apply`` takes another.
GROUP_SIZE = 4096


def init_moe(gen: torch.Generator, d_model: int, mcfg: MoEConfig, gated: bool, dtype):
    """Random parameters with the reference's distributions, drawn in its
    order from ``gen`` on ``gen.device``."""
    p = {"router": L.init_dense(gen, d_model, mcfg.n_experts, torch.float32)}
    if mcfg.router == "sigmoid":
        p["bias"] = torch.zeros((mcfg.n_experts,), dtype=torch.float32, device=gen.device)
    p["w_in"] = _init_experts(gen, mcfg.n_held, d_model, mcfg.d_ff_expert, dtype)
    p["w_out"] = _init_experts(gen, mcfg.n_held, mcfg.d_ff_expert, d_model, dtype)
    if gated:
        p["w_gate"] = _init_experts(gen, mcfg.n_held, d_model, mcfg.d_ff_expert, dtype)
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


def _reads_occupied(params, x, rows: int, expert_impl: str) -> bool:
    """Whether the expert products of x (the layer's input or its dispatched
    rows), ``rows`` an expert, take ``moe_experts``: the kernel path, decode
    shapes, plain tensors that need no gradient, a type the kernel takes on
    a card."""
    w = params["w_in"]
    return (expert_impl == "kernel" and rows <= KX.ROW_LIMIT
            and not isinstance(x, DTensor) and not isinstance(w, DTensor)
            and not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad))
            and (x.device.type == "cpu" or (x.device.type == "cuda" and x.dtype in KX.DTYPES)))


def _occupied_ffn(params, xe, counts):
    """xe: (E, R, d) -> (E, R, d): the experts whose count (E,) int32 is
    above 0 over their rows, zeros for the rest."""
    tracing.count("moe.experts", xe.shape[0])
    tracing.count_device("moe.experts_read", counts, at_least=1)
    return KO.moe_experts(xe, counts, params["w_in"], params.get("w_gate"), params["w_out"])


def _dispatched_ffn(params, xd, dispatch, expert_impl):
    """``_expert_ffn`` of the dispatched rows xd (G, E, C, d); where
    ``_reads_occupied``, only over the experts that hold a kept slot of
    ``dispatch`` (G, T, E, C)."""
    g, e, c, d = xd.shape
    if not _reads_occupied(params, xd, g * c, expert_impl):
        return _expert_ffn(params, xd)
    counts = dispatch.sum(dim=(0, 1, 3), dtype=torch.int32)               # (E,)
    ye = _occupied_ffn(params, xd.movedim(1, 0).reshape(e, g * c, d).contiguous(), counts)
    return ye.reshape(e, g, c, d).movedim(0, 1)


def moe_apply(params, x, mcfg: MoEConfig, impl: str = "einsum",
              group_size: int = GROUP_SIZE, static: bool = False,
              expert_impl: str = "kernel"):
    """x: (B, S, d). Returns (y (B, S, d), aux_loss 0-d f32, None for a
    sigmoid-routed layer).  ``impl`` and ``group_size`` apply to softmax
    routing, ``static`` to sigmoid routing; ``expert_impl`` "kernel" lets
    decode shapes take ``moe_experts``, any other the products over every
    expert (see the module's docstring)."""
    if mcfg.router == "sigmoid":
        return _moe_held(params, x, mcfg, static, expert_impl), None
    if mcfg.router != "softmax":
        raise ValueError(f"unknown router {mcfg.router!r}")
    if mcfg.ep_size != 1:
        raise ValueError("softmax routing holds every expert (ep_size 1)")
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
            ye = constrain(_dispatched_ffn(params, xd, dispatch, expert_impl),
                           "data", "model", None, None)
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


# ---------------------------------------------------------------------------
# sigmoid routing (noaux_tc), dropless, over the held experts
# ---------------------------------------------------------------------------
def _route_sigmoid(params, xf, mcfg: MoEConfig):
    """xf: (T, d) -> (top_w (T, k) f32, top_i (T, k)): the top-k by sigmoid
    score plus the selection bias (equal values in index order), weighted
    by their unbiased scores, normalised, times ``routed_scale``."""
    scores = torch.sigmoid(xf.float() @ params["router"])          # (T, E)
    _, top_i = _top_k(scores + params["bias"], mcfg.top_k)
    top_w = scores.gather(-1, top_i)
    top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20) * mcfg.routed_scale
    return top_w, top_i


def _one_expert(params, j: int, xe):
    """Held expert j over its tokens xe (n, d)."""
    h = xe @ params["w_in"][j]
    if "w_gate" in params:
        h = F.silu(xe @ params["w_gate"][j]) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ params["w_out"][j]


def _moe_held(params, x, mcfg: MoEConfig, static: bool, expert_impl: str):
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    with tracing.span("moe.route"):
        top_w, top_i = _route_sigmoid(params, xf, mcfg)
    with tracing.span("moe.dispatch"):
        loc = top_i - mcfg.first_held                               # (T, k) held index
        held = (loc >= 0) & (loc < mcfg.n_held)
        tracing.count("moe.pairs", top_i.numel())
        tracing.count_device("moe.held", held, at_least=1)
    y = (_held_static(params, xf, top_w, loc, held, expert_impl) if static
         else _held_sorted(params, xf, top_w, loc, held))
    with tracing.span("moe.combine"):
        y = _add_shared(params, y.to(x.dtype), xf)
    return y.reshape(b, s, d)


def _held_static(params, xf, top_w, loc, held, expert_impl):
    """Every held expert over every row, each row's output weighed by the
    pairs routed to it (zero for the rest): static shapes, no host wait.
    Where ``_reads_occupied``, an expert gets only its routed rows (the
    others zeroed), and an expert with none is not read.  Returns (T, d)
    f32."""
    t, d = xf.shape
    nh = params["w_in"].shape[0]
    occupied = _reads_occupied(params, xf, t, expert_impl)
    with tracing.span("moe.dispatch"):
        idx = loc.clamp(0, nh - 1)
        w = torch.zeros((t, nh), dtype=torch.float32, device=xf.device).scatter_add_(
            1, idx, torch.where(held, top_w, 0.0))
        if occupied:
            routed = torch.zeros((t, nh), dtype=torch.int32, device=xf.device).scatter_add_(
                1, idx, held.to(torch.int32)).T.contiguous()         # (nh, T): 0 or 1
            xe = torch.where(routed[:, :, None] > 0, xf, 0.0)       # (nh, T, d)
    with tracing.span("moe.experts"):
        ye = (_occupied_ffn(params, xe, routed.sum(dim=1, dtype=torch.int32)) if occupied
              else _expert_ffn(params, xf.expand(nh, t, d)))        # (nh, T, d)
    with tracing.span("moe.combine"):
        return torch.einsum("etd,te->td", ye.float(), w)


def _held_sorted(params, xf, top_w, loc, held):
    """The held pairs sorted by expert, each expert over its own tokens (the
    per-expert counts read on the host).  Returns (T, d) f32."""
    t, d = xf.shape
    k = loc.shape[1]
    with tracing.span("moe.dispatch"):
        pair = held.reshape(-1).nonzero()[:, 0]                     # (P,), token-major
        e = loc.reshape(-1)[pair]
        order = torch.argsort(e, stable=True)
        pair = pair[order]
        counts = torch.bincount(e, minlength=params["w_in"].shape[0]).tolist()
        tok = pair // k
        xs = xf[tok]
    with tracing.span("moe.experts"):
        outs, a = [], 0
        for j, n in enumerate(counts):
            if n:
                outs.append(_one_expert(params, j, xs[a:a + n]))
                a += n
        ye = torch.cat(outs) if outs else xs
    with tracing.span("moe.combine"):
        wts = top_w.reshape(-1)[pair]
        return torch.zeros((t, d), dtype=torch.float32, device=xf.device).index_add_(
            0, tok, ye.float() * wts[:, None])
