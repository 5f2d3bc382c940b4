"""Meshes, after ``repro/launch/mesh.py``.

``make_local_mesh`` builds a real ``torch.distributed`` ``DeviceMesh`` with
axes ``("data", "model")`` over the process group this process already
belongs to (``torchrun`` and ``init_process_group`` make one; a single
process may be a group of one).  ``MeshShape``
(``repro_torch.distributed.sharding``) is a mesh's shape alone, the ordered
axis names and sizes that the sharding rules read, which the dry run uses
for the production meshes.  The reference's
``mesh_axis_types`` and ``make_mesh_compat`` paper over JAX versions
(``jax.sharding.AxisType``) and have no counterpart.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import device as D
from repro_torch.distributed.sharding import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: 16x16 = 256 devices (data, model).
    Multi-pod: 2 pods x 256 = 512 devices (pod, data, model)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1, device: D.DeviceLike = None) -> DeviceMesh:
    """A (data, model) ``DeviceMesh`` over the initialised process group,
    whose world size must be ``data * model``: one rank a card (NCCL) by
    default, or CPU ranks (gloo) for ``device="cpu"``."""
    dev = D.resolve(device)
    if not dist.is_initialized():
        raise RuntimeError(f"a {data}x{model} mesh needs an initialised process group "
                           "(torchrun, or torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != data * model:
        raise RuntimeError(f"a {data}x{model} mesh needs {data * model} ranks; "
                           f"the process group has {world}")
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))

