"""Flat-npz checkpoints in the reference's format
(``repro/training/checkpoint.py``).

A file holds the reference's *stacked* parameter tree
(``convert.params_to_jax``), one array per leaf under the key of its tree
path: ``d<key>`` for a dictionary key (in sorted order, as ``jax.tree_util``
walks them), ``i<idx>`` for a list or tuple index, joined by ``::``.  Files
of either package load in the other.  bf16 leaves are written as the
reference writes its ``ml_dtypes.bfloat16`` arrays: descriptor ``<V2`` and
the raw bits, so each member is byte for byte the reference's; ``np.load``
reads such a leaf as ``V2`` and ``load`` takes its bits as bf16 (the
reference's own ``load`` cannot read it back, ROADMAP R6).

On a mesh ``save`` gathers each DTensor leaf on every rank and rank 0
writes the file; ``load`` places the leaves it reads under a spec tree.
"""
from __future__ import annotations

import os
import zipfile
from typing import Any, Dict

import numpy as np
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import device as D
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import convert
from repro_torch.training import optim

_SEP = "::"


def _flatten(tree, prefix=()) -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        items = [(f"d{k}", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"i{i}", v) for i, v in enumerate(tree)]
    else:
        return {_SEP.join(prefix): tree}
    flat = {}
    for key, sub in items:
        flat.update(_flatten(sub, prefix + (key,)))
    return flat


def _unflatten(flat: Dict[str, np.ndarray]):
    """The tree whose leaf paths are the keys of ``flat``."""
    root: dict = {}
    for key, arr in flat.items():
        node, parts = root, key.split(_SEP)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr

    def build(node):
        if not isinstance(node, dict):
            return node
        if all(k.startswith("i") for k in node):
            return tuple(build(node[f"i{i}"]) for i in range(len(node)))
        return {k[1:]: build(v) for k, v in node.items()}
    return build(root)


def _check_layout(tree, cfg: ModelConfig) -> None:
    """Assert that the file holds ``cfg``'s stacked layout."""
    from repro_torch.models import stack as ST
    want = (cfg.vocab, cfg.d_model)
    assert tree["embed"].shape == want, ("embed", tree["embed"].shape, want)
    plans = [("stack", ST.decoder_plan(cfg))]
    if cfg.family == "encdec":
        plans.append(("enc_stack", ST.encoder_plan(cfg)))
    for name, pl in plans:
        # an empty tuple leaves no key in the file
        blocks = tree[name].setdefault("blocks", ())
        rem = tree[name].setdefault("rem", ())
        assert len(blocks) == (pl.period if pl.n_rep else 0) and len(rem) == len(pl.rem), \
            (name, len(blocks), len(rem), pl)
        for block in blocks:
            for leaf in _flatten(block).values():
                assert leaf.shape[0] == pl.n_rep, (name, leaf.shape, pl.n_rep)


def _write_member(zf: zipfile.ZipFile, name: str, a: np.ndarray) -> None:
    with zf.open(name + ".npy", "w", force_zip64=True) as f:
        if a.dtype == convert.BF16_BITS:
            header = {"descr": "<V2", "fortran_order": False, "shape": a.shape}
            np.lib.format.write_array_header_1_0(f, header)
            f.write(np.ascontiguousarray(a).tobytes())
        else:
            np.lib.format.write_array(f, a, allow_pickle=False)


def save(path: str, params: Any, cfg: ModelConfig) -> None:
    """Every rank of a mesh calls it (the gather is collective); rank 0
    writes."""
    params = optim.tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t,
                            params)
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if not path.endswith(".npz"):
        path += ".npz"
    flat = _flatten(convert.params_to_jax(params, cfg))
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, a in flat.items():
            _write_member(zf, key, a)


def load(path: str, cfg: ModelConfig, *, device: D.DeviceLike = None, mesh=None,
         specs=None):
    """The port's parameters from a checkpoint of either package; each leaf
    keeps the type it was saved in.  With a ``DeviceMesh``, DTensors placed
    by ``specs`` (a spec tree of the port's layout)."""
    dev = D.resolve(device)
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        tree = _unflatten({k: data[k] for k in data.files})
    _check_layout(tree, cfg)
    params = convert.params_from_jax(tree, cfg, device=dev)
    return params if mesh is None else shd.distribute(params, mesh, specs)
