"""Mamba2 mixer (SSD, state-space duality, arXiv:2405.21060), after
``repro/models/ssm.py``.

``mamba_forward`` runs the SSD scan through ``impl``:

  * ``kernel`` -- ``repro_torch.kernels.ops.ssd_scan``: the CUDA kernel on
                  the card, its plain version on the CPU;
  * ``naive``  -- ``ssd_chunked``, the chunked algorithm in plain PyTorch
                  (it is the kernel's plain version); ``chunked``, the
                  reference's training default, runs it too.

``ssd_reference`` is the naive O(S) recurrence oracle.  ``mamba_decode``
advances the state by one token in plain tensor code; the reference has no
decode kernel for SSM layers.  Rounding follows the reference in the
model's type: the conv accumulates in f32 and casts after the silu, the
skip term ``D * x`` is cast before it is added in prefill and added in f32
before the cast in decode.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.distributed.api import batchwise, einsum, data_partial_grad
from repro_torch.kernels import ops
# the chunked algorithm is K3's plain version; one copy serves both names
from repro_torch.kernels.ssd_scan import segsum as _segsum  # noqa: F401
from repro_torch.kernels.ssd_scan import ssd_scan_plain as ssd_chunked
from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def init_mamba(gen: torch.Generator, d_model: int, scfg: SSMConfig, dtype):
    """``A_log``, ``D`` and ``dt_bias`` stay f32 in a bf16 model, as in the
    reference: the decay ``-exp(A_log)`` needs the digits."""
    din = scfg.d_inner(d_model)
    nh = scfg.n_heads(d_model)
    gn = scfg.n_groups * scfg.d_state
    conv_dim = din + 2 * gn
    dev = gen.device
    conv_w = torch.randn((conv_dim, scfg.d_conv), generator=gen, dtype=torch.float32,
                         device=dev) * 0.1
    return {
        "in_proj": L.init_dense(gen, d_model, 2 * din + 2 * gn + nh, dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32, device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "norm": torch.zeros((din,), dtype=dtype, device=dev),
        "out_proj": L.init_dense(gen, din, d_model, dtype),
    }


# ---------------------------------------------------------------------------
# SSD oracle
# ---------------------------------------------------------------------------
def ssd_reference(x, dt, a_neg, b_mat, c_mat, init_state=None):
    """Naive O(S) recurrence oracle (float32).  Returns (y (B,S,H,P) f32,
    final_state (B,H,P,N))."""
    b, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    hpg = h // g
    bm = b_mat.repeat_interleave(hpg, dim=2).float()
    cm = c_mat.repeat_interleave(hpg, dim=2).float()
    xf, dtf = x.float(), dt.float()
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t] * a_neg[None])                       # (B,H)
        state = state * da[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", xf[:, t] * dtf[:, t, :, None], bm[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cm[:, t]))
    return torch.stack(ys, dim=1), state


# ---------------------------------------------------------------------------
# full mixer
# ---------------------------------------------------------------------------
def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) at every x: torch's
    ``softplus`` returns x itself above its threshold of 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_proj(params, x, d_model, scfg):
    din = scfg.d_inner(d_model)
    gn = scfg.n_groups * scfg.d_state
    zxbcdt = x @ params["in_proj"]
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:2 * din + 2 * gn]
    dt_raw = zxbcdt[..., 2 * din + 2 * gn:]
    return z, xbc, dt_raw


def _causal_conv(xbc, w, bias):
    """Depthwise causal conv. xbc: (B, S, C); w: (C, K).  f32 accumulate,
    then bias, then silu, then the cast to xbc's type."""
    k = w.shape[-1]
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(k):
        out = out + pad[:, i:i + s, :].float() * w[:, i].float()
    return F.silu(out + bias.float()).to(xbc.dtype)


def mamba_forward(params, x, d_model: int, scfg: SSMConfig, init_state=None,
                  impl: str = "kernel"):
    """x: (B, S, d). Returns (y (B,S,d), cache {"conv", "state"})."""
    b, s, _ = x.shape
    din = scfg.d_inner(d_model)
    gn = scfg.n_groups * scfg.d_state
    nh = scfg.n_heads(d_model)
    z, xbc, dt_raw = _split_proj(params, x, d_model, scfg)
    conv_in = xbc
    # on a mesh the conv and the scan run on each rank's rows: torch 2.11's
    # DTensor rule for the conv's constant_pad_nd fails on a mesh of 2 dims,
    # and it has no rule for the scan's aten.flip
    xbc = batchwise(_causal_conv, (xbc,), (params["conv_w"], params["conv_b"]))
    xh = xbc[..., :din].reshape(b, s, nh, scfg.head_dim)
    bmat = xbc[..., din:din + gn].reshape(b, s, scfg.n_groups, scfg.d_state)
    cmat = xbc[..., din + gn:].reshape(b, s, scfg.n_groups, scfg.d_state)
    dt = _softplus(dt_raw.float() + params["dt_bias"])
    a_neg = -torch.exp(params["A_log"])
    if impl == "kernel":
        y, final = ops.ssd_scan(xh.contiguous(), dt, a_neg, bmat.contiguous(),
                                cmat.contiguous(), chunk=scfg.chunk_size,
                                init_state=init_state)
    elif impl in ("naive", "chunked"):
        def scan(xh, dt, bmat, cmat, init, a_neg):
            return ssd_chunked(xh, dt, a_neg, bmat, cmat, scfg.chunk_size, init_state=init)
        y, final = batchwise(scan, (xh, dt, bmat, cmat, init_state), (a_neg,))
    else:
        raise ValueError(f"unknown ssd impl {impl!r}")
    y = y + (params["D"][None, None, :, None] * xh.float()).to(y.dtype)
    y = y.reshape(b, s, din)
    y = L.rms_norm(y * F.silu(z.float()).to(y.dtype), params["norm"])
    # on a mesh the out projection's gradient reaches the norm sharded over
    # data as y is: torch 2.11 cannot add a partial sum to a shard there
    out = data_partial_grad(y) @ params["out_proj"]
    # decode cache: the last (d_conv - 1) conv inputs, left-padded with
    # zeros for a shorter prompt, copied out of the projection's output
    k = scfg.d_conv
    conv_cache = (conv_in[:, s - (k - 1):, :] if s >= k - 1
                  else batchwise(lambda c: F.pad(c, (0, 0, k - 1 - s, 0)), (conv_in,))
                  ).contiguous()
    return out, {"conv": conv_cache, "state": final}


def mamba_decode(params, x, cache, d_model: int, scfg: SSMConfig):
    """x: (B, 1, d); cache: {"conv": (B, K-1, C), "state": (B, H, P, N) f32}.
    Returns (y (B,1,d), new cache)."""
    b = x.shape[0]
    din = scfg.d_inner(d_model)
    gn = scfg.n_groups * scfg.d_state
    nh = scfg.n_heads(d_model)
    z, xbc, dt_raw = _split_proj(params, x, d_model, scfg)
    window = torch.cat([cache["conv"], xbc], dim=1)                   # (B, K, C)
    new_conv = window[:, 1:, :]
    w = params["conv_w"].float()                                      # (C, K)
    conv_out = einsum("bkc,ck->bc", window.float(), w)
    xbc1 = F.silu(conv_out + params["conv_b"].float()).to(x.dtype)    # (B, C)
    xh = xbc1[:, :din].reshape(b, nh, scfg.head_dim)
    bmat = xbc1[:, din:din + gn].reshape(b, scfg.n_groups, scfg.d_state)
    cmat = xbc1[:, din + gn:].reshape(b, scfg.n_groups, scfg.d_state)
    hpg = nh // scfg.n_groups
    bmat = bmat.repeat_interleave(hpg, dim=1)                         # (B,H,N)
    cmat = cmat.repeat_interleave(hpg, dim=1)
    dt = _softplus(dt_raw[:, 0].float() + params["dt_bias"])          # (B,H)
    a_neg = -torch.exp(params["A_log"])
    da = torch.exp(dt * a_neg[None])
    state = cache["state"].float()
    state = state * da[..., None, None] + einsum(
        "bhp,bhn->bhpn", xh.float() * dt[..., None], bmat.float())
    y = einsum("bhpn,bhn->bhp", state, cmat.float())
    y = y + params["D"][None, :, None] * xh.float()
    y = y.to(x.dtype).reshape(b, 1, din)
    y = L.rms_norm(y * F.silu(z.float()).to(y.dtype), params["norm"])
    out = y @ params["out_proj"]
    return out, {"conv": new_conv, "state": state}
