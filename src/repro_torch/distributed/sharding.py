"""Parameter / batch / cache sharding rules for every architecture family,
after ``repro/distributed/sharding.py``: the same specs, computed in plain
Python from leaf paths, shapes and mesh axis sizes.

Logical layout:
  * serving + training: attention heads, FFN hidden, experts, SSM heads and
    the vocabulary shard over the ``model`` axis (Megatron-style TP / expert
    parallel); the batch shards over ``data`` (x ``pod`` multi-pod).
  * training additionally FSDP-shards each >=2D weight's largest replicated
    dim over ``data`` (x ``pod``).
  * long-context decode (batch 1): the KV cache seq dim context-parallels
    over ``data``.

Axes that do not divide a dim are dropped (replicate instead) -- e.g.
starcoder2's kv=2 heads cannot split 16 ways, so K/V stay replicated over
``model`` while Q shards.

The rules read the reference's *stacked* layout, where a repeated block's
leaves carry a leading ``n_rep`` axis: FSDP shards "the largest
still-replicated dim" of a leaf with two or more dims, which on a stacked
norm scale ``(n_rep, d)`` may be either axis and on the port's per-layer
``(d,)`` leaf is none.  So ``param_specs`` and ``cache_specs`` take trees in
that layout (``repro_torch.models.convert.param_shapes`` and
``cache_shapes`` give them from the port's parameters and caches), with
path strings as the reference builds them (``stack/blocks/0/attn/wq``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims, or
anything with ``.shape`` (an ordered ``{axis: size}`` dict) and
``.axis_names``, such as ``MeshShape``, a mesh's shape alone.

``named`` turns specs into DTensor placements on a ``DeviceMesh``, as the
reference's turns them into ``NamedSharding``s: one placement a mesh dim,
``Shard(d)`` on the mesh dims that tensor dim ``d`` names (several, major
to minor, for a tuple entry such as ``("pod", "data")``), ``Replicate()``
on the others.  ``distribute`` places a tree of tensors by them.  The
port's per-layer parameters take the stacked specs through
``convert.specs_from_jax``, which drops a block leaf's layer entry
(ROADMAP P10: an axis the rules put on the layer axis of a stacked leaf
is replicated on the per-layer leaf).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.configs.base import InputShape, ModelConfig


class PartitionSpec(tuple):
    """One entry per dim: None (replicated), a mesh axis name, or a tuple of
    names (sharded over their product); compares equal to the tuple of a
    ``jax.sharding.PartitionSpec`` with the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and their sizes, in mesh order."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} sizes")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: Tuple[str, ...]            # ("data",) or ("pod", "data")
    model: Tuple[str, ...]           # ("model",)

    @classmethod
    def of(cls, mesh) -> "MeshAxes":
        names = mesh_shape(mesh).axis_names
        data = tuple(a for a in ("pod", "data") if a in names)
        return cls(data=data, model=("model",) if "model" in names else ())


def mesh_shape(mesh):
    """A ``DeviceMesh`` as its ``MeshShape``; any other mesh as it is."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return mesh
    return MeshShape(tuple(names), tuple(mesh.shape))


def _axis_size(mesh, axes: Tuple[str, ...]) -> int:
    shape = mesh_shape(mesh).shape
    s = 1
    for a in axes:
        s *= shape[a]
    return s


def _fit(mesh, dim: int, axes: Tuple[str, ...]):
    """axes if they evenly divide dim, else None (replicate)."""
    if not axes or dim % _axis_size(mesh, axes) != 0:
        return None
    return axes if len(axes) > 1 else axes[0]


def _leaf_spec(path: str, shape: Tuple[int, ...], mesh, ax: MeshAxes,
               fsdp: bool, expert_mode: str = "none") -> P:
    """Spec for one parameter leaf, identified by its tree path string.

    ``expert_mode``:
      * "hidden_data": additionally shard expert FFN hidden over ``data``
        (2D-resident expert weights),
      * "hidden_model": shard expert FFN hidden over ``model`` (for expert
        counts that don't divide the model axis, e.g. qwen2's 60)."""
    nd = len(shape)
    spec: list = [None] * nd

    def put(dim: int, axes: Tuple[str, ...]) -> bool:
        if 0 <= dim < nd and spec[dim] is None:
            got = _fit(mesh, shape[dim], axes)
            if got is not None:
                spec[dim] = got
                return True
        return False

    model = ax.model
    # dims are right-aligned (stacked block params add a leading dim)
    if path.endswith("embed"):
        put(nd - 2, model)                       # vocab
    elif "wq" in path or ("wk" in path) or ("wv" in path):
        put(nd - 2, model)                       # heads
    elif "wo" in path:
        put(nd - 3, model)                       # heads
    elif "w_in" in path or "w_gate" in path:
        if "moe" in path and nd >= 3:
            put(nd - 3, model)                   # experts
            if expert_mode == "hidden_data":
                put(nd - 1, ax.data)             # expert hidden over data
                return P(*spec)
            if expert_mode == "hidden_model":
                put(nd - 1, model)
                return P(*spec)
        else:
            put(nd - 1, model)                   # ffn hidden
    elif "w_out" in path:
        if "moe" in path and nd >= 3:
            put(nd - 3, model)                   # experts
            if expert_mode == "hidden_data":
                put(nd - 2, ax.data)
                return P(*spec)
            if expert_mode == "hidden_model":
                put(nd - 2, model)
                return P(*spec)
        else:
            put(nd - 2, model)                   # ffn hidden
    elif "router" in path:
        put(nd - 1, model)                       # experts
    elif "in_proj" in path:
        put(nd - 1, model)                       # ssm inner
    elif "out_proj" in path:
        put(nd - 2, model)                       # ssm inner
    elif "conv_w" in path:
        put(nd - 2, model)
    elif path.endswith(("conv_b", "A_log", "D", "dt_bias")) or path.endswith("norm"):
        put(nd - 1, model)

    if fsdp and nd >= 2:
        # shard the largest still-replicated dim over data(+pod)
        order = sorted(range(nd), key=lambda d: -shape[d])
        for d in order:
            if spec[d] is None and put(d, ax.data):
                break
    return P(*spec)


def map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, tuples and lists whose leaves
    have ``.shape``; the path joins dict keys and sequence indices with
    "/", as the reference's ``_path_str`` does."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(params_shape, mesh, *, fsdp: bool = False,
                expert_mode: str = "none"):
    """Spec tree matching a params tree in the reference's stacked layout."""
    ax = MeshAxes.of(mesh)

    def one(path, leaf):
        return _leaf_spec(path, tuple(leaf.shape), mesh, ax, fsdp, expert_mode)

    return map_with_path(one, params_shape)


def batch_specs(cfg: ModelConfig, shape: InputShape, mesh):
    """Specs for the input batch dict."""
    ax = MeshAxes.of(mesh)
    bdim = _fit(mesh, shape.global_batch, ax.data)

    def spec_for(name: str, arr_shape):
        return P(bdim, *([None] * (len(arr_shape) - 1)))

    return spec_for


def cache_specs(cfg: ModelConfig, shape: InputShape, mesh, caches_shape):
    """Decode cache specs: batch over data when divisible, else context-
    parallel (KV seq over data) + heads/experts over model."""
    ax = MeshAxes.of(mesh)
    batch_ok = shape.global_batch % max(_axis_size(mesh, ax.data), 1) == 0 \
        and shape.global_batch >= _axis_size(mesh, ax.data)

    def one(p, leaf):
        nd = len(leaf.shape)
        spec: list = [None] * nd
        if p.endswith("k") or p.endswith("v") or "xk" in p or "xv" in p:
            # (..., B, L, kv, hd)
            b_dim, l_dim, h_dim = nd - 4, nd - 3, nd - 2
            if batch_ok:
                spec[b_dim] = _fit(mesh, leaf.shape[b_dim], ax.data)
            else:
                spec[l_dim] = _fit(mesh, leaf.shape[l_dim], ax.data)
            # kv heads over model when they divide; otherwise context-
            # parallel the cache seq dim over model (GQA kv < mesh model)
            spec[h_dim] = _fit(mesh, leaf.shape[h_dim], ax.model)
            if spec[h_dim] is None and spec[l_dim] is None:
                spec[l_dim] = _fit(mesh, leaf.shape[l_dim], ax.model)
        elif p.endswith("conv"):
            b_dim, c_dim = nd - 3, nd - 1
            if batch_ok:
                spec[b_dim] = _fit(mesh, leaf.shape[b_dim], ax.data)
            spec[c_dim] = _fit(mesh, leaf.shape[c_dim], ax.model)
        elif p.endswith("state"):
            b_dim, h_dim = nd - 4, nd - 3
            if batch_ok:
                spec[b_dim] = _fit(mesh, leaf.shape[b_dim], ax.data)
            spec[h_dim] = _fit(mesh, leaf.shape[h_dim], ax.model)
        return P(*spec)

    return map_with_path(one, caches_shape)


def axis_rules(mesh) -> dict:
    ax = MeshAxes.of(mesh)
    return {"data": ax.data, "model": ax.model}


def placements(mesh, spec: P) -> tuple:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        unknown = [a for a in axes if a not in names]
        if unknown:
            raise ValueError(f"{spec}: the mesh {names} has no axis {unknown}")
        dims = [names.index(a) for a in axes]
        # DTensor shards a dim over several mesh dims in mesh order, JAX in
        # the entry's order: the two agree only when they are the same
        if dims != sorted(dims):
            raise ValueError(f"{spec}: entry {entry} names axes out of mesh order {names}")
        for m in dims:
            if out[m] != Replicate():
                raise ValueError(f"{spec}: axis {names[m]!r} shards two dims")
            # a dim over one device is whole: DTensor's views refuse to drop
            # a dim sharded even one way
            out[m] = Shard(d) if mesh.size(m) > 1 else Replicate()
    return tuple(out)


def _map_specs(fn, tree):
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return type(tree)(_map_specs(fn, v) for v in tree)


def named(mesh, spec_tree):
    """Placements for every spec of ``spec_tree``, tree for tree."""
    return _map_specs(lambda s: placements(mesh, s), spec_tree)


def distribute(tree, mesh, spec_tree):
    """Every tensor of ``tree`` as a DTensor on ``mesh`` under its spec.
    Each rank must hold the same full tree (a seeded init, one checkpoint,
    one batch of the seeded stream): a rank keeps its own shards and sends
    nothing."""
    if isinstance(tree, dict):
        return {k: distribute(v, mesh, spec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(v, mesh, s) for v, s in zip(tree, spec_tree))
    return distribute_tensor(tree, mesh, placements(mesh, spec_tree), src_data_rank=None)
