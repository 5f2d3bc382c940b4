"""Mesh-agnostic sharding hints, after ``repro/distributed/api.py``.

The models call ``constrain(x, "data", None, "model")`` to pin activations
inside a mesh.  A ``DeviceMesh`` is active inside ``use_mesh(mesh)``,
which sets its axis rules too; there ``constrain`` redistributes a DTensor to the
placements of ``resolve(names)``, as the reference's
``with_sharding_constraint`` pins a traced array.  Anywhere else, and on a
plain tensor, it is the identity, so the models run unchanged outside a
mesh.  The mapping of logical axis names onto mesh axes (the multi-pod mesh
folds "pod" into "data") is the reference's.

``einsum`` and ``batchwise`` run a function on each rank's local shards
where DTensor's own rules would flatten two sharded dims into one, or have
no rule at all, in the PyTorch releases the port runs on (2.11 refuses
both; ROADMAP lists the sites).  Outside a mesh they call the function as
it is.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._pytree import tree_map_only

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import PartitionSpec as P

# logical -> physical axis mapping; "data" may expand to ("pod", "data").
_ACTIVE_RULES: Optional[dict] = None
# the DeviceMesh the models' activations live on, or None
_ACTIVE_MESH = None


def set_axis_rules(rules: Optional[dict]) -> None:
    """rules: {"data": ("pod", "data"), "model": ("model",)} or None to clear."""
    global _ACTIVE_RULES
    _ACTIVE_RULES = rules


def get_axis_rules() -> Optional[dict]:
    return _ACTIVE_RULES


@contextlib.contextmanager
def use_mesh(mesh):
    """``mesh`` active, with its axis rules, for the block; plain tensors
    that meet DTensors there (positions, masks, the step count) count as
    replicated on it.  The previous mesh and rules come back after."""
    global _ACTIVE_MESH, _ACTIVE_RULES
    prev = _ACTIVE_MESH, _ACTIVE_RULES
    _ACTIVE_MESH, _ACTIVE_RULES = mesh, shd.axis_rules(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _ACTIVE_MESH, _ACTIVE_RULES = prev


def resolve(spec_names: Tuple[Optional[str], ...]) -> P:
    rules = _ACTIVE_RULES or {}
    out = []
    for name in spec_names:
        if name is None:
            out.append(None)
        else:
            phys = rules.get(name, ())
            if not phys:
                out.append(None)
            elif len(phys) == 1:
                out.append(phys[0])
            else:
                out.append(tuple(phys))
    return P(*out)


def _active_mesh_axes():
    """{axis: size} of the active mesh, or None when none is."""
    if _ACTIVE_MESH is None:
        return None
    return shd.mesh_shape(_ACTIVE_MESH).shape


def mesh_axis_size(logical: str) -> int:
    """Active-mesh size of a logical axis ("data"/"model"); 1 if no mesh."""
    if _ACTIVE_RULES is None:
        return 1
    sizes = _active_mesh_axes()
    if sizes is None:
        return 1
    out = 1
    for phys in _ACTIVE_RULES.get(logical, ()):
        out *= sizes.get(phys, 1)
    return out


def _whole(x, dim: int, parts: int):
    mesh = x.device_mesh
    pl = tuple(Replicate() if p == Shard(dim) and parts % mesh.size(i) else p
               for i, p in enumerate(x.placements))
    return x.view_as(x) if pl == tuple(x.placements) else x.redistribute(mesh, pl)


class _WholePieces(torch.autograd.Function):
    """``_whole`` on the way in and on the gradient's way back."""

    @staticmethod
    def forward(ctx, x, dim, parts):
        ctx.dim, ctx.parts = dim, parts
        return _whole(x, dim, parts)

    @staticmethod
    def backward(ctx, grad):
        return _whole(grad, ctx.dim, ctx.parts), None, None


def whole_pieces(x, dim: int, parts: int):
    """A DTensor ``x`` with ``dim`` gathered on each mesh dim whose shards
    would cut one of ``parts`` equal pieces of it, and its gradient the
    same, so that ``dim`` can be viewed as ``(parts, dim // parts)`` both
    ways; any other tensor as it is.

    aten.view cannot split a dim so sharded, and DTensor shards a product's
    output columns wherever the weight is replicated (a projection onto KV
    heads that do not divide the model axis, or the gradient of the heads
    that the output projection merges)."""
    if not isinstance(x, DTensor):
        return x
    return _WholePieces.apply(x, dim % x.dim(), parts)


def _strides(shape):
    """The strides of a new contiguous tensor of ``shape``."""
    out, n = [], 1
    for size in reversed(shape):
        out.append(n)
        n *= size
    return tuple(reversed(out))


def _dense(t):
    """``t`` with the strides of a new contiguous tensor of its shape, size-1
    dims included (``contiguous`` leaves those as they are)."""
    if t.stride() == _strides(t.shape):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def constrain(x, *names: Optional[str]):
    """``x`` redistributed to ``resolve(names)`` if it is a DTensor and a
    mesh is active, else ``x``.

    Skips axes whose size does not divide the dim, and skips entirely on
    rank mismatch (helpers are reused at several ranks)."""
    if _ACTIVE_RULES is None:
        return x
    axes = _active_mesh_axes()
    if axes is None or not isinstance(x, DTensor):
        return x
    if x.dim() != len(names):
        return x
    spec = resolve(names)

    def keep(entry, dim):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in axes)
            if not kept:
                return None
            size = 1
            for a in kept:
                size *= axes[a]
            return kept if dim % size == 0 else None
        if entry not in axes or dim % axes[entry] != 0:
            return None
        return entry

    spec = P(*[keep(e, d) for e, d in zip(spec, x.shape)])
    out = x.redistribute(_ACTIVE_MESH, shd.placements(_ACTIVE_MESH, spec))
    # a shard cut from a replica along a later dim is a strided view of it,
    # which aten.view (a product's flattening) refuses: copy it
    if not out.to_local().is_contiguous():
        out = out.clone(memory_format=torch.contiguous_format)
    return out


class _DataPartialGrad(torch.autograd.Function):
    """The identity; on the way back a gradient that is a partial sum over
    a data axis that shards the input is reduce-scattered onto the input's
    shards there, and left as it is elsewhere."""

    @staticmethod
    def forward(ctx, x):
        mesh = x.device_mesh
        data = set(shd.MeshAxes.of(mesh).data)
        ctx.mesh = mesh
        ctx.pl = tuple(p if name in data and p.is_shard() else None
                       for name, p in zip(mesh.mesh_dim_names, x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if not isinstance(grad, DTensor):
            return grad
        pl = tuple(p if p is not None and g.is_partial() else g
                   for p, g in zip(ctx.pl, grad.placements))
        return grad if pl == tuple(grad.placements) else grad.redistribute(ctx.mesh, pl)


def data_partial_grad(x):
    """``x`` itself; on a DTensor its gradient, where it is a partial sum
    over a data axis that shards ``x`` (by its rows), comes back
    reduce-scattered onto ``x``'s shards there.  The gradient of a product
    with an FSDP weight may leave it a partial sum over data, which torch
    2.11 cannot add to a gradient sharded over data (it would turn the
    shard into a partial sum)."""
    if not isinstance(x, DTensor):
        return x
    return _DataPartialGrad.apply(x)


class _ToLocal(torch.autograd.Function):
    """A DTensor's local shard once redistributed to ``pl``.  Its gradient
    comes back as a DTensor of placements ``grad_pl``, with the global
    shape and dense strides (``to_local`` infers global strides from local
    ones, which a size-1 local dim leaves ambiguous), and is redistributed
    to the DTensor's own placements on each mesh dim where it is not a
    partial sum.  A partial sum stays one and meets the gradient's other
    parts as one: torch 2.11 can add two, but not turn a shard into one."""

    @staticmethod
    def forward(ctx, x, pl, grad_pl):
        ctx.mesh, ctx.grad_pl, ctx.shape = x.device_mesh, grad_pl, x.shape
        ctx.back = [g if g.is_partial() else Replicate() if p.is_partial() else p
                    for g, p in zip(grad_pl, x.placements)]
        local = x.redistribute(x.device_mesh, pl).to_local()
        return local.view_as(local)

    @staticmethod
    def backward(ctx, grad):
        g = DTensor.from_local(_dense(grad), ctx.mesh, ctx.grad_pl, run_check=False,
                               shape=ctx.shape, stride=_strides(ctx.shape))
        if ctx.back != list(ctx.grad_pl):
            g = g.redistribute(ctx.mesh, ctx.back)
        return g, None, None


def _from_local(t, mesh, placements):
    """A DTensor of local shard ``t`` (dense) under ``placements``, every
    shard even, with dense global strides."""
    shape = list(t.shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            shape[p.dim] *= mesh.size(i)
    return DTensor.from_local(_dense(t), mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=_strides(shape))


def _local(fn, mesh, args, labels, out_labels, chosen):
    """``fn`` on the local shards of ``args``.  ``labels[j]`` names the dims
    of ``args[j]`` (a string, a letter a dim), ``out_labels`` those of every
    output, ``chosen`` the label sharded on each mesh dim (or None).  An
    argument is sharded on that mesh dim along its label's dim, or
    replicated where it lacks the label, and then its gradient comes back
    as a partial sum; an output is sharded along the label, or a partial sum
    where the label is summed over, or replicated where no label was
    chosen."""
    local = []
    for a, lab in zip(args, labels):
        if a is None:
            local.append(None)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        pl = [Shard(lab.index(c)) if c is not None and c in lab else Replicate()
              for c in chosen]
        grad = [Partial() if c is not None and c not in lab else p
                for p, c in zip(pl, chosen)]
        local.append(_ToLocal.apply(a, pl, grad))
    out_pl = [Replicate() if c is None else Shard(out_labels.index(c)) if c in out_labels
              else Partial() for c in chosen]
    return tree_map_only(torch.Tensor, lambda t: _from_local(t, mesh, out_pl), fn(*local))


def _choose(mesh, args, labels, out_labels):
    """A label a mesh dim (or None): one an argument is sharded along on
    that dim, first one that every argument and the output carry (no
    collective), dividing its dim's size by the mesh dims that shard it."""
    sizes = {c: n for a, lab in zip(args, labels) for c, n in zip(lab, a.shape)}
    split = {c: 1 for c in sizes}
    chosen = []
    for i in range(mesh.ndim):
        found = [lab[p.dim] for a, lab in zip(args, labels) if isinstance(a, DTensor)
                 for p in (a.placements[i],) if p.is_shard()]
        found = sorted(found, key=lambda c: not (c in out_labels and all(
            c in lab for lab in labels)))
        ok = [c for c in found if sizes[c] % (split[c] * mesh.size(i)) == 0]
        c = ok[0] if ok else None
        if c is not None:
            split[c] *= mesh.size(i)
        chosen.append(c)
    return chosen


def einsum(equation: str, *operands):
    """``torch.einsum``; on DTensors, shard by shard: a label each mesh dim
    keeps sharded (``_choose``), the operands redistributed to it, the local
    einsum, the result sharded along the label or a partial sum over it.
    DTensor's own einsum flattens the batch dims into one, which torch 2.11
    cannot do where two of them are sharded (batch over data and heads over
    model in attention, groups and experts in the MoE dispatch)."""
    mesh = next((x.device_mesh for x in operands if isinstance(x, DTensor)), None)
    if mesh is None:
        return torch.einsum(equation, *operands)
    ins, out = equation.replace(" ", "").split("->")
    ins = ins.split(",")
    return _local(lambda *xs: torch.einsum(equation, *xs), mesh, operands, ins, out,
                  _choose(mesh, operands, ins, out))


def batchwise(fn, rows, params=()):
    """``fn(*rows, *params)``, where each tensor of ``rows`` (an entry may be
    None) and of the result has the batch along dim 0, and ``fn`` treats
    each row apart.  On DTensors it runs on each rank's rows: the rows
    sharded over the data axes where the batch divides them and replicated
    on the other mesh dims, ``params`` replicated (their gradients partial
    sums).  For operations torch 2.11 has no DTensor rule for
    (``aten.flip``, ``aten.roll``, ``index_put`` with sharded indices) or
    one that fails on a mesh of two dims (``constant_pad_nd``)."""
    mesh = next((x.device_mesh for x in (*rows, *params) if isinstance(x, DTensor)), None)
    if mesh is None:
        return fn(*rows, *params)
    data = set(shd.MeshAxes.of(mesh).data)
    size, split, chosen = rows[0].shape[0], 1, []
    for i, name in enumerate(mesh.mesh_dim_names):
        if name in data and size % (split * mesh.size(i)) == 0:
            split *= mesh.size(i)
            chosen.append("b")
        else:
            chosen.append(None)
    labels = ["b" if r is None else "b" + "x" * (r.dim() - 1) for r in rows]
    labels += ["x" * p.dim() for p in params]
    return _local(fn, mesh, (*rows, *params), labels, "b", chosen)
