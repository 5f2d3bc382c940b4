"""Mesh-agnostic sharding hints, after ``repro/distributed/api.py``.

The reference's model code calls ``constrain(x, "data", None, "model")`` to
pin activations inside a mesh and is the identity outside one.  The port
runs on one card and has no ambient mesh, so ``constrain`` returns its input
and ``mesh_axis_size`` is 1; the port's models do not call them.  What stays
is the mapping of logical axis names onto mesh axes (the multi-pod mesh
folds "pod" into "data"), which ``resolve`` turns into a spec.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.distributed.sharding import PartitionSpec as P

# logical -> physical axis mapping; "data" may expand to ("pod", "data").
_ACTIVE_RULES: Optional[dict] = None


def set_axis_rules(rules: Optional[dict]) -> None:
    """rules: {"data": ("pod", "data"), "model": ("model",)} or None to clear."""
    global _ACTIVE_RULES
    _ACTIVE_RULES = rules


def get_axis_rules() -> Optional[dict]:
    return _ACTIVE_RULES


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


def mesh_axis_size(logical: str) -> int:
    """Size of a logical axis on the active mesh: 1, since the port has no
    active mesh (the reference's is 1 outside one too)."""
    return 1


def constrain(x, *names: Optional[str]):
    """The identity: the reference pins ``x`` to ``resolve(names)`` only
    inside an active mesh, which the port never has."""
    return x
