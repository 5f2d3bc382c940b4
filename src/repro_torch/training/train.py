"""Loss and train step, after ``repro/training/train.py``: chunked
cross-entropy against the tied embedding, AdamW, per-layer remat.

Gradients come from ``torch.autograd`` through the naive or chunked
attention paths (``impl``); the CUDA kernels have no backward and refuse
inputs that require grad.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import device as D
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.api import constrain
from repro_torch.models import model as M
from repro_torch.models import stack as ST
from repro_torch.training import data, optim

LOSS_CHUNK = 2048


def cross_entropy(hidden, embed, labels, chunk: int = LOSS_CHUNK):
    """hidden: (B, S, d); embed: (V, d); labels: (B, S) with -1 = masked.

    Computed in sequence chunks so the (B, C, V) f32 logits block -- not the
    full (B, S, V) tensor -- is the peak memory."""
    b, s, d = hidden.shape

    def chunk_loss(h, y):
        lg = constrain(h.float() @ embed.float().T, "data", None, "model")
        logz = torch.logsumexp(lg, dim=-1)
        # aten.gather along a vocab-sharded dim leaves DTensor a masked
        # partial that it fails to reduce: gather from replicated logits
        lg = constrain(lg, "data", None, None)
        gold = lg.gather(-1, y.clamp(min=0).long()[..., None])[..., 0]
        mask = (y >= 0).float()
        return ((logz - gold) * mask).sum(), mask.sum()

    if s % chunk == 0 and s > chunk:
        tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(s // chunk):
            cols = slice(i * chunk, (i + 1) * chunk)
            l, c = chunk_loss(hidden[:, cols], labels[:, cols])
            tot, cnt = tot + l, cnt + c
    else:
        tot, cnt = chunk_loss(hidden, labels)
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params, cfg: ModelConfig, batch, *, impl="chunked",
            moe_impl="einsum", remat=False):
    hidden, aux = M.forward(params, cfg, batch, impl=impl,
                            moe_impl=moe_impl, remat=remat)
    ce = cross_entropy(hidden, params["embed"], batch["labels"])
    return ce + aux, {"ce": ce, "aux": aux}


def decay_mask(params, cfg: ModelConfig):
    """The leaves AdamW decays, as the reference decides on its stacked tree:
    a layer of a repeated block is stacked along a leading axis there, so
    all its leaves (norm scales included) have ``ndim >= 2`` and decay; the
    remainder layers, ``embed`` and the final norms go by their own
    ``ndim`` (ROADMAP R7)."""
    mask = optim.tree_map(lambda p: p.dim() >= 2, params)
    plans = [("stack", ST.decoder_plan(cfg))]
    if cfg.family == "encdec":
        plans.append(("enc_stack", ST.encoder_plan(cfg)))
    for name, pl in plans:
        for j in range(pl.n_rep * pl.period):
            mask[name][j] = optim.tree_map(lambda p: True, params[name][j])
    return mask


def make_train_step(cfg: ModelConfig, ocfg: optim.AdamWConfig, *,
                    impl="chunked", moe_impl="einsum", remat=False):
    """Returns train_step(params, opt_state, batch) -> (params, state, metrics),
    which updates ``params`` and ``opt_state`` in place and returns them.
    The parameters require grad only inside the step."""

    def train_step(params, opt_state, batch):
        leaves = optim.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, parts = loss_fn(params, cfg, batch, impl=impl,
                                  moe_impl=moe_impl, remat=remat)
            flat = iter(torch.autograd.grad(loss, leaves, materialize_grads=True))
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = optim.tree_map(lambda _: next(flat), params)
        with torch.profiler.record_function("apply_updates"):
            params, opt_state, om = optim.apply_updates(params, grads, opt_state, ocfg,
                                                        decay=decay_mask(params, cfg))
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()},
                   **om}
        return params, opt_state, metrics

    return train_step


def train_loop(cfg: ModelConfig, stream, steps: int, *, seed: int = 0,
               ocfg: Optional[optim.AdamWConfig] = None, log_every: int = 10,
               impl="naive", verbose: bool = True, device: D.DeviceLike = None):
    """Single-device training loop (examples + tests)."""
    dev = D.resolve(device)
    ocfg = ocfg or optim.AdamWConfig(total_steps=steps)
    params = M.init(cfg, seed=seed, device=dev)
    opt_state = optim.init_state(params)
    step_fn = make_train_step(cfg, ocfg, impl=impl)
    history = []
    it = iter(stream)
    for i in range(steps):
        batch = data.to_device(next(it), dev)
        params, opt_state, m = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            rec = {k: float(v) for k, v in m.items()}
            rec["step"] = i
            history.append(rec)
            if verbose:
                print(f"step {i:5d} loss={rec['loss']:.4f} "
                      f"ce={rec['ce']:.4f} gnorm={rec['grad_norm']:.3f}")
    return params, opt_state, history
