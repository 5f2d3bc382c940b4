"""AdamW, after ``repro/training/optim.py``.

Parameters are the port's tree: dictionaries (walked in sorted key order,
as ``jax.tree_util`` walks them) and lists of per-layer dictionaries, with
tensor leaves.  The moments ``mu`` and ``nu`` are f32 trees of the same
structure, ``step`` an int32 0-d tensor.  ``apply_updates`` clips by the
global norm, corrects the bias in f32, decays only leaves with
``ndim >= 2``, updates in f32 and casts back to each leaf's type, as the
reference does; it writes the new parameters and moments into the tensors
it was given (under ``torch.no_grad()``) and returns them.  The reference
judges ``ndim`` on its stacked tree, where every leaf of a repeated block
has a leading layer axis, so it decays the norm scales of those layers too
(ROADMAP R7): ``decay`` takes a tree of booleans that says which leaves to
decay (``train.decay_mask`` gives the reference's choice for a model).

``global_norm`` sums the leaves in the port's order, layer by layer; the
reference sums its stacked leaves, so the two agree within f32 rounding,
not bit for bit.

On a mesh the leaves are DTensors: the moments take their parameters'
placements (``init_state``), a gradient that comes back partial (summed
over the batch's shards) is reduce-scattered onto its parameter's
placements first, as FSDP does, and each leaf's square sum is a partial
sum over its shards that DTensor reduces across the mesh before the
leaves are summed in the same order.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_leaves(tree):
    """The tensors of a tree of dicts and lists, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``) in ``tree_leaves`` order; the same structure back."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def schedule(cfg: AdamWConfig, step):
    """Linear warmup, then cosine down to ``min_lr_ratio``; f32 0-d tensor."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_state(params):
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    leaf = tree_leaves(params)[0]
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def global_norm(tree):
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(leaves).sum())


def _placed_like(g, p):
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig, *, decay=None):
    """Returns (params, state, metrics), the first two updated in place.
    ``decay``: a tree of booleans beside ``params``, the leaves to decay;
    by default those with ``ndim >= 2``."""
    if decay is None:
        decay = tree_map(lambda p: p.dim() >= 2, params)
    grads = tree_map(_placed_like, grads, params)
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()
    for p, g, mu, nu, dec in zip(*(tree_leaves(t) for t in (params, grads, state["mu"],
                                                            state["nu"], decay))):
        g = g.float() * clip
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * g.square())
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if dec:  # decay matrices only (norms/scalars exempt)
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
