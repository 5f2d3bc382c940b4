"""Mesh shapes, after ``repro/launch/mesh.py``.

The port has no device mesh: a mesh here is its shape, the ordered axis
names and sizes that ``repro_torch.distributed.sharding`` reads.  The
reference's ``mesh_axis_types`` and ``make_mesh_compat`` paper over JAX
versions (``jax.sharding.AxisType``) and have no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


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


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: 16x16 = 256 devices (data, model).
    Multi-pod: 2 pods x 256 = 512 devices (pod, data, model)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1) -> MeshShape:
    """A (data, model) mesh over the cards of this host; raises unless
    ``data * model`` of them are there."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if data * model > have:
        raise RuntimeError(f"a {data}x{model} mesh needs {data * model} CUDA devices; "
                           f"this host has {have}")
    return MeshShape(("data", "model"), (data, model))
