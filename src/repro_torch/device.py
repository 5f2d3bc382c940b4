"""The device rule of the port's entry points.

``device=None`` means the card: an entry point called without a device on a
machine without CUDA raises instead of quietly running on the CPU.  Tests
and CPU runs pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
