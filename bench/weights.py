"""The benchmark's seeded weights.

``make_weights`` makes one named tensor per published weight, as the
stage's layout lists them (``bench/layouts/<layout>.py::shapes``: name,
shape, kind of initialiser, fan-in), stored (fan_in, fan_out) so that
``x @ w`` needs no transpose.  Every bf16 tensor is a view into one flat
buffer that a few ``normal_`` calls fill on the device from a
``torch.Generator`` seeded from the run's seed and the stage's index; each
tensor is then scaled in place by its kind: dense and embed by one over the
root of the fan-in or width, norm and conv by 0.1, zero to 0.  The few f32
tensors (a router, a layout's own kinds) are drawn one by one after it, in
the layout's order, from the same generator: they are small.  The layout's
``to_port`` arranges views of the same tensors into the program's parameter
tree; it copies nothing.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bench import spec

CHUNK = 1 << 30          # elements a normal_ call


def _router(s, fan_in, gen, device):
    return torch.randn(s, generator=gen, device=device) / fan_in ** 0.5


# f32 initialisers by kind, (shape, fan_in, generator, device) -> tensor; a
# layout adds its own kinds under its F32_INIT
F32_INIT = {"router": _router,
            "ones": lambda s, fan_in, gen, device: torch.ones(s, device=device),
            "zero32": lambda s, fan_in, gen, device: torch.zeros(s, device=device)}


def _f32_inits(st: dict) -> dict:
    return {**F32_INIT, **getattr(spec.layout(st), "F32_INIT", {})}


def n_bytes(st: dict, dtype=torch.bfloat16) -> int:
    item = torch.finfo(dtype).bits // 8
    f32 = _f32_inits(st)
    return sum(int(np.prod(s)) * (4 if k in f32 else item)
               for _, s, k, _ in spec.layout(st).shapes(st))


def stage_seed(seed: int, stage: int) -> int:
    return int(np.random.SeedSequence([seed, stage]).generate_state(1, np.uint64)[0] >> 1)


def make_weights(st: dict, seed: int, stage: int, device,
                 dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(stage_seed(seed, stage))
    sh = spec.layout(st).shapes(st)
    f32 = _f32_inits(st)
    total = sum(int(np.prod(s)) for _, s, k, _ in sh if k not in f32)
    flat = torch.empty(total, dtype=dtype, device=device)
    for a in range(0, total, CHUNK):
        flat[a:a + CHUNK].normal_(generator=gen)
    out, off = {}, 0
    for name, s, kind, fan_in in sh:
        n = int(np.prod(s))
        if kind in f32:
            out[name] = f32[kind](s, fan_in, gen, device)
            continue
        t = flat[off:off + n].view(s)
        off += n
        if kind in ("dense", "embed"):
            t.mul_(1.0 / fan_in ** 0.5 if kind == "dense" else 1.0 / st["hidden_size"] ** 0.5)
        elif kind in ("norm", "conv"):
            t.mul_(0.1)
        elif kind == "zero":
            t.zero_()
        out[name] = t
    return out
