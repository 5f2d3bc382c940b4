"""The Mamba2 SSD chunked scan: the Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` (``ssd_scan``
/ ``_ssd_kernel``) with ``csrc/ssd_scan.cu``.

What bounds it on an H100 (data-sheet rates at the card's 700 W power
limit): bytes.  At the full-width prefill (B 4, S 1024, 80 heads of
P 64, one group of N 128, chunk 256, bf16) the scan must read x, dt, B and
C and write y and the f32 final state, about 98 MB, 29 us at 3.35 TB/s;
the least arithmetic (C.B^T once per batch, chunk and group, the masked
lower triangle of the intra-chunk product, the inter-chunk and state
products per head) is about 16 GFLOP, 16 us at 989 TFLOP/s.

The kernel is chosen by dtype, and each dtype has exactly one:

* bf16, the serving path: the plain version's passes, each parallel over
  chunks, with every product on the tensor cores (``mma.sync`` m16n8k16):
  C.B^T once per (batch, chunk, group) into an f32 scratch; each chunk's
  state contribution per head; the state passed from chunk to chunk; each
  chunk's output per 64-row tile.  Four device kernels a call, every block
  small enough that two or more share an SM.  x, B and C enter the
  products exactly; the f32 operands (the decayed scores, the scaled B, the
  carried state) enter as three bf16 terms (hi + mid + lo), since one
  rounding to bf16 misses the tolerances and two terms round y to another
  bf16 value than the plain version's about ten times as often
  (``tests/test_torch_kernels.py`` holds that plan on the CPU,
  ``chip_smoke.py`` and ``tests/test_torch_gpu.py`` on the card).  The
  wrapper allocates one f32 scratch buffer for the passes.
* f32, the reduced families the profiler measures and the f32 parity
  checks: one block a (batch, head) walks the chunks in order with the
  (P, N) f32 state in shared memory, products on the f32 CUDA cores, as
  the TPU kernel computes them in f32.

Both sum every decay exponent over its own segment and never compute the
upper triangle of the decay mask.  ``ssd_scan.launches`` counts calls of
the wrapper, not the device kernels inside one call.

On a CPU tensor ``ssd_scan`` computes the plain version; on a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64)             # P
STATE_DIMS = (8, 16, 32, 64, 128)    # N
CHUNKS = (16, 32, 64, 128, 256)


def _check(x, dt, a_neg, b_mat, c_mat, chunk, init_state):
    if x.dim() != 4 or dt.dim() != 3 or a_neg.dim() != 1 or b_mat.dim() != 4:
        raise ValueError(f"want x (B,S,H,P), dt (B,S,H), a_neg (H,), B/C (B,S,G,N); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(a_neg.shape)}, "
                         f"{tuple(b_mat.shape)}")
    b, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if dt.shape != (b, s, h) or a_neg.shape != (h,):
        raise ValueError(f"dt {tuple(dt.shape)} or a_neg {tuple(a_neg.shape)} disagree "
                         f"with x {tuple(x.shape)}")
    if c_mat.shape != b_mat.shape or b_mat.shape[:2] != (b, s):
        raise ValueError(f"B {tuple(b_mat.shape)} and C {tuple(c_mat.shape)} must both be "
                         f"({b}, {s}, G, N)")
    if s == 0:
        raise ValueError("the sequence is empty")
    if g == 0 or h % g:
        raise ValueError(f"groups ({g}) must divide heads ({h})")
    if p not in HEAD_DIMS or n not in STATE_DIMS or chunk not in CHUNKS:
        raise ValueError(f"head_dim {p}, d_state {n}, chunk {chunk}: want head_dim in "
                         f"{HEAD_DIMS}, d_state in {STATE_DIMS}, chunk in {CHUNKS}")
    if x.dtype not in DTYPES or b_mat.dtype != x.dtype or c_mat.dtype != x.dtype:
        raise ValueError(f"x, B, C dtypes {x.dtype}, {b_mat.dtype}, {c_mat.dtype}: "
                         f"want one of {DTYPES}, all alike")
    if dt.dtype != torch.float32 or a_neg.dtype != torch.float32:
        raise ValueError(f"dt and a_neg must be float32; got {dt.dtype}, {a_neg.dtype}")
    tensors = [x, dt, a_neg, b_mat, c_mat]
    if init_state is not None:
        if init_state.shape != (b, h, p, n) or init_state.dtype != torch.float32:
            raise ValueError(f"init_state must be float32 ({b}, {h}, {p}, {n}); got "
                             f"{init_state.dtype} {tuple(init_state.shape)}")
        tensors.append(init_state)
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, dt, a_neg, B, C and init_state must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, dt, a_neg, B, C and init_state must be contiguous")
    if x.device.type == "cuda" and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("x, dt, a_neg, B, C and init_state must start on a 16-byte "
                         "boundary (the kernels copy 16-byte pieces)")


def segsum(a):
    """a: (..., l) -> (..., l, l) with out[i, j] = sum_{k in (j, i]} a_k for
    i >= j and -inf above the diagonal, so that ``exp`` gives 0 there.

    Each segment is summed directly (a cumsum down the rows of the masked
    matrix, the stable form of the Mamba2 reference code), not as a
    difference of two prefix sums: over a 256-row chunk the prefix sums reach
    thousands, and their difference keeps only a few 1e-4 of absolute
    precision in the exponent."""
    li = a.shape[-1]
    rows = a[..., :, None].expand(*a.shape, li)                    # [i, j] = a_i
    lower = torch.ones((li, li), dtype=torch.bool, device=a.device).tril()
    seg = torch.cumsum(rows.masked_fill(~lower.tril(-1), 0.0), dim=-2)
    return seg.masked_fill(~lower, -torch.inf)


def ssd_scan_plain(x, dt, a_neg, b_mat, c_mat, chunk: int = 256, init_state=None):
    """The chunked SSD algorithm (Mamba2 Listing 1), as
    ``repro/models/ssm.py::ssd_chunked`` computes it: zero padding to a
    multiple of the chunk, f32 throughout, y cast to x's dtype.  The decay
    exponents within a chunk are direct segment sums (``segsum``), where the
    reference subtracts prefix sums; the kernel sums them the same way.

    x: (B, S, H, P); dt: (B, S, H), already softplus'ed; a_neg: (H,);
    b_mat, c_mat: (B, S, G, N) with H = G * hpg.
    Returns (y (B, S, H, P), final_state (B, H, P, N) f32)."""
    b, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    nc, li = sp // chunk, chunk
    hpg = h // g
    bm = b_mat.repeat_interleave(hpg, dim=2).float()               # (B,S,H,N)
    cm = c_mat.repeat_interleave(hpg, dim=2).float()
    xf = x.float() * dt[..., None]                                 # fold dt in
    da = dt * a_neg[None, None, :]                                 # (B,S,H) log decay

    def ch(t):  # (B, S, ...) -> (B, nc, l, ...)
        return t.reshape((b, nc, li) + t.shape[2:])
    xc, bc, cc, dac = ch(xf), ch(bm), ch(cm), ch(da)

    # intra-chunk (diagonal blocks)
    dach = dac.movedim(-1, 2)                                      # (B,nc,H,l)
    lmat = torch.exp(segsum(dach))                                 # (B,nc,H,l,l)
    scores = torch.einsum("bclhn,bcshn->bchls", cc, bc)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * lmat, xc)

    # per-chunk end states; exp(sum over (j, l)) is the last row of lmat
    cum = torch.cumsum(dach, dim=-1)                               # (B,nc,H,l)
    decay_to_end = lmat[..., -1, :]
    states = torch.einsum("bcshn,bcshp->bchpn", bc,
                          xc * decay_to_end.movedim(2, 3)[..., None])

    # inter-chunk recurrence: prev[c] is the state entering chunk c
    chunk_decay = torch.exp(cum[..., -1])                          # (B,nc,H)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                         # (B,nc,H,P,N)

    out_decay = torch.exp(cum)                                     # (B,nc,H,l)
    y_off = torch.einsum("bclhn,bchpn->bclhp", cc, prev_states) \
        * out_decay.movedim(2, 3)[..., None]

    y = (y_diag + y_off).reshape(b, sp, h, p)[:, :s]
    return y.to(x.dtype), state


@functools.cache
def _function():
    lib = _build.load("ssd_scan")
    fn = lib.repro_ssd_scan
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def ssd_scan(x, dt, a_neg, b_mat, c_mat, *, chunk: int = 256, init_state=None):
    """x: (B, S, H, P) f32 or bf16; dt: (B, S, H) f32; a_neg: (H,) f32;
    b_mat, c_mat: (B, S, G, N) in x's dtype; init_state: (B, H, P, N) f32
    or None.  S need not be a multiple of ``chunk``.  A CUDA tensor runs the
    tensor-core passes for bf16 and the CUDA-core kernel for f32 (see the
    module's docstring), or raises.

    Returns (y (B, S, H, P) in x's dtype, final_state (B, H, P, N) f32)."""
    _check(x, dt, a_neg, b_mat, c_mat, chunk, init_state)
    _build.refuse_autograd("ssd_scan", x, dt, a_neg, b_mat, c_mat, init_state)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a_neg, b_mat, c_mat, chunk, init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CPU or CUDA, not {x.device}")
    lib, fn = _function()
    b, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    y = torch.empty_like(x)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    s0 = init_state.data_ptr() if init_state is not None else None
    bf16 = x.dtype == torch.bfloat16
    ptrs = [None] * 3
    if bf16:   # one f32 scratch: C.B^T per group, the chunk states, their decay exponents
        nc = -(-s // chunk)
        sizes = (b * nc * g * chunk * chunk, b * nc * h * p * n, b * nc * h)
        scratch = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
        ptrs = [scratch.data_ptr() + 4 * sum(sizes[:i]) for i in range(3)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(), b_mat.data_ptr(),
                 c_mat.data_ptr(), s0, y.data_ptr(), final.data_ptr(), *ptrs, b, s, h, g,
                 p, n, chunk, int(bf16), stream)
    ssd_scan.launches += 1
    _build.check(lib, err, "ssd_scan")
    return y, final


ssd_scan.launches = 0
