"""The expert products of a mixture-of-experts layer at decode shapes, over
the experts that hold a row only: the Hopper kernel and its plain version.

Replaces no TPU kernel: the reference's experts are XLA einsums over every
expert (``repro/models/moe.py::_expert_ffn``), as the port's batched
products were.  At decode an expert holds a few rows and most experts none,
yet a product over every expert reads every expert's weights; this reads
only those of the experts whose row count is above 0, and writes exact
zeros for the others.  The counts live on the device and are read there,
so a CUDA graph that captures a call follows each replay's routing.

What bounds it on an H100: bytes.  R rows do R FLOPs a weight byte, far
below the card's ridge of about 295, so its least time is the occupied
experts' weights over 3.35 TB/s (3 d f x 2 bytes an expert).  The design
(``csrc/moe_experts.cu``'s header): a static grid of (column tiles of 128,
splits of the depth) whose blocks read the counts first and walk the
experts that hold a row, the depth split so that the grid is one wave of
about a block an SM (``split_plan``); the up product, then the down product;
a split's f32 partials summed in split order by the last block to arrive on
an int32 arrival counter that the wrapper keeps per (device, stream) and
the kernel leaves at zero, so results are the same from run to run.

The kernel takes bf16; the plain version any float type.  On a CPU tensor
``moe_experts`` computes the plain version; on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

ROW_LIMIT = 16            # rows an expert: the tensor-core product's M
MAX_EXPERTS = 384
DTYPES = (torch.bfloat16,)
BN, BK = 128, 64          # the kernel's column tile and depth stage
# the most blocks a launch: one on each of an H100's 132 SMs (two fit), so
# the grid is one wave and every block walks the same experts
TARGET_BLOCKS = 132


def split_plan(k: int, n: int):
    """``(splits, kc)`` for a product of depth k and n columns: split s
    reads rows ``[s * kc, (s + 1) * kc)``, kc a multiple of BK, every split
    non-empty, together covering k; column tiles times splits at most
    TARGET_BLOCKS where the column tiles allow."""
    tiles, ktiles = -(-n // BN), -(-k // BK)
    splits = max(1, min(ktiles, TARGET_BLOCKS // tiles))
    per = -(-ktiles // splits)
    return -(-ktiles // per), per * BK


def _check(x, counts, w_in, w_gate, w_out):
    if x.dim() != 3 or w_in.dim() != 3 or w_out.dim() != 3:
        raise ValueError(f"want x (E,R,d), w_in (E,d,f), w_out (E,f,d); got {tuple(x.shape)}, "
                         f"{tuple(w_in.shape)}, {tuple(w_out.shape)}")
    e, r, d = x.shape
    f = w_in.shape[2]
    if w_in.shape != (e, d, f) or w_out.shape != (e, f, d) or (
            w_gate is not None and w_gate.shape != w_in.shape):
        raise ValueError(f"x {tuple(x.shape)} and the weights disagree: w_in "
                         f"{tuple(w_in.shape)}, w_out {tuple(w_out.shape)}"
                         + ("" if w_gate is None else f", w_gate {tuple(w_gate.shape)}"))
    if not 1 <= r <= ROW_LIMIT:
        raise ValueError(f"{r} rows an expert: want 1 to {ROW_LIMIT}")
    if not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"{e} experts: want 1 to {MAX_EXPERTS}")
    if d % 8 or f % 8:
        raise ValueError(f"d {d} and f {f} must be multiples of 8 (16-byte copies)")
    if counts.shape != (e,) or counts.dtype != torch.int32:
        raise ValueError(f"counts must be int32 of shape ({e},); got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    ws = [w for w in (w_in, w_gate, w_out) if w is not None]
    if not x.is_floating_point() or any(w.dtype != x.dtype for w in ws):
        raise ValueError(f"x {x.dtype} and the weights {[w.dtype for w in ws]} must share "
                         f"one float type")
    if any(t.device != x.device for t in [counts, *ws]):
        raise ValueError("x, counts and the weights must be on one device")
    if not all(t.is_contiguous() for t in [x, counts, *ws]):
        raise ValueError("x, counts and the weights must be contiguous")
    if x.device.type == "cuda":
        if x.dtype not in DTYPES:
            raise ValueError(f"the kernel takes {DTYPES}, not {x.dtype}")
        if any(t.data_ptr() % 16 for t in [x, *ws]):
            raise ValueError("x and the weights must start on a 16-byte boundary (the kernel "
                             "copies 16-byte pieces)")


def moe_experts_plain(x, counts, w_in, w_gate, w_out):
    """The kernel's function in plain PyTorch: the MoE layer's batched
    products over every expert (``models/moe.py::_expert_ffn``), exact zeros
    where the count is 0."""
    from repro_torch.models import moe      # imported here: moe imports this module
    p = {"w_in": w_in, "w_out": w_out} | ({} if w_gate is None else {"w_gate": w_gate})
    return torch.where((counts > 0)[:, None, None], moe._expert_ffn(p, x), 0)


@functools.cache
def _function():
    lib = _build.load("moe_experts")
    fn = lib.repro_moe_experts
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


# (device index, stream) -> int32 arrival counters, zero between launches:
# the last block of an (expert, column tile) resets its counter, and one
# stream runs its launches in order.  At least 8192 of them (jamba's up
# product needs 16 x 112, qwen2-moe's 60 x 16), so that the serving shapes
# never grow the buffer: a graph captured before a growth would keep the
# old one's address.
_counters = {}


def _counter_buffer(device, stream: int, n: int):
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 8192), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def moe_experts(x, counts, w_in, w_gate, w_out):
    """x: (E, R, d) rows an expert; counts: (E,) int32, an expert's rows
    are computed where its count is above 0; w_in, w_gate: (E, d, f)
    (w_gate None for tanh-GELU experts); w_out: (E, f, d).  Returns (E, R,
    d) in x's dtype, exact zeros for an expert whose count is 0."""
    _check(x, counts, w_in, w_gate, w_out)
    _build.refuse_autograd("moe_experts", x, w_in, w_gate, w_out)
    if x.device.type == "cpu":
        return moe_experts_plain(x, counts, w_in, w_gate, w_out)
    if x.device.type != "cuda":
        raise ValueError(f"moe_experts runs on CPU or CUDA, not {x.device}")
    lib, fn = _function()
    e, r, d = x.shape
    f = w_in.shape[2]
    up, down = split_plan(d, f), split_plan(f, d)
    mats = 1 if w_gate is None else 2
    ws_n = max(up[0] * mats * r * f if up[0] > 1 else 0, down[0] * r * d if down[0] > 1 else 0)
    h = torch.empty((e, r, f), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws = torch.empty(e * ws_n, dtype=torch.float32, device=x.device) if ws_n else None
        counters = _counter_buffer(x.device, stream, e * -(-max(d, f) // BN))
        err = fn(x.data_ptr(), counts.data_ptr(), w_in.data_ptr(),
                 None if w_gate is None else w_gate.data_ptr(), w_out.data_ptr(),
                 h.data_ptr(), y.data_ptr(), None if ws is None else ws.data_ptr(),
                 counters.data_ptr(), e, r, d, f, *up, *down, stream)
    moe_experts.launches += 1
    _build.check(lib, err, "moe_experts")
    return y


moe_experts.launches = 0
