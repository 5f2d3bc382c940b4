"""The plain reference of the benchmark's configurations, in float32: what
every layout's reference shares, and the comparison.

Each layout's forward pass is ``bench/reference/<layout>.py``'s
``forward(w, st, batches, prompt_len, n_out, prec)``, found by the stage's
``layout`` key (``bench/spec.py``).  It is written from the published
equations and the configuration files, in plain PyTorch: no kernel, no
cache, no batching beyond the rows it is handed.  It reads the benchmark's
weights (the layout's names, ``bench/weights.py``) and upcasts each to
float32 as a layer uses it, so it needs one layer's float32 weights at a
time.

``prec="fp8"`` is the comparison's control: every product with a weight
(projections, experts, router, logits) takes its operands rounded to
float8 e4m3 (per output column for the weight, per row for the
activation), the rest stays float32.

Nothing here imports the program, jax or the reference package ``repro``.
"""
from __future__ import annotations

import torch

from bench import spec

FP8_MAX = 448.0


def _q8(t, dim):
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x, w, prec="f32"):
    """x (..., k) @ w (k, n) in float32, or with both operands rounded to
    fp8 for the control."""
    w = w.float()
    if prec == "fp8":
        return _q8(x, -1) @ _q8(w, -2)
    return x @ w


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def rope(x, theta):
    """x: (R, T, heads, hd), positions 0..T-1, half-split rotation."""
    t, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freqs
    sin, cos = torch.sin(ang)[None, :, None], torch.cos(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def gaps(ref_logits, chosen):
    """How far each chosen token's reference logit lies below the
    reference's best: (R, G) >= 0."""
    return ref_logits.max(-1).values - ref_logits.gather(-1, chosen[..., None])[..., 0]


def stage_gaps(w, st, prompts, served, control=False):
    """One stage over the sample: ``prompts`` and ``served`` are lists with
    one (R_b, S) and one (R_b, G) tensor a batch.  Returns the gaps of the
    served tokens, and with ``control`` those of the tokens the fp8 control
    puts first at the same positions, each (sum R_b, G)."""
    batches = [torch.cat([p, s[:, :-1]], dim=1) for p, s in zip(prompts, served)]
    s_len, g = prompts[0].shape[1], served[0].shape[1]
    forward = spec.reference(st).forward
    ref = torch.cat(forward(w, st, batches, s_len, g))
    chosen = torch.cat(served)
    got = gaps(ref, chosen)
    ctl = None
    if control:
        low = torch.cat(forward(w, st, batches, s_len, g, prec="fp8"))
        ctl = gaps(ref, low.argmax(-1))
    return got, ctl
