"""Top-level model API of the dense, VLM, MoE, Mamba2 (``ssm``), hybrid and
enc-dec families, after ``repro/models/model.py``.

  init(cfg, seed=, device=)                -> params
  encode(params, cfg, frames)              -> enc-dec encoder output (B,F,d)
  forward(params, cfg, batch, ...)         -> (hidden (B,S,d), aux)
  logits(params, cfg, hidden)              -> (B, S, V)
  prefill(params, cfg, batch, ...)         -> (hidden_last (B,d), caches, prompt_len)
  decode_step(params, cfg, caches, t, tok) -> (logits (B,V), caches)

``batch`` keys: "tokens" (B,S) integer tensor always; "patches" (B,P,d) for
vlm (the projected patch stub), prepended to the token embeddings; "frames"
(B,F,d) for encdec (whisper's frame-embedding stub), which the encoder reads
and ``forward`` and ``prefill`` require.  The decode path operates past the
prefix.  Parameters are a dictionary: ``embed`` (V, d), ``stack`` (a list of
per-layer dictionaries in layer order) and ``final_norm`` (d,), and for
encdec ``enc_stack`` and ``enc_norm``.  A layer's cache is ``{"k", "v"}``
for attention, with the encoder's K/V ``{"xk", "xv"}`` (B, F, KV, hd) beside
them in an enc-dec decoder, and ``{"conv", "state"}`` (the last
``d_conv - 1`` conv inputs in the model's type, the SSM state in f32) for
Mamba2; ``impl`` picks the kernels (``kernel``, serving's default; no
backward), the naive paths or the reference's chunked attention
(``chunked``, trainable) for attention (the encoder's, the decoder's and the
cross-attention alike) and the SSD scan,
and ``moe_impl`` the MoE dispatch (``einsum``, the reference's default, or
``gather``).  ``aux`` is the sum of the MoE layers' balancing losses, a 0-d
f32 tensor that is zero for models without MoE.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import device as D
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.api import batchwise, constrain
from repro_torch.models import layers as L
from repro_torch.models import stack as ST


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device, so that the init
    functions, which allocate on ``gen.device``, build shapes only (PyTorch
    has no generator on meta)."""

    @property
    def device(self):
        return torch.device("meta")


def init(cfg: ModelConfig, *, seed: int = 0, device: D.DeviceLike = None):
    """Random parameters with the reference's distributions, drawn from a
    generator seeded with ``seed`` on ``device`` (the card by default;
    ``"meta"`` gives the shapes and types without memory, at any width).
    The numbers differ from ``repro.models.model.init``'s: tests that
    compare the two packages convert the reference's parameters instead."""
    dev = D.resolve(device)
    gen = (_MetaGenerator() if dev.type == "meta"
           else torch.Generator(device=dev)).manual_seed(seed)
    emb = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                      dtype=torch.float32, device=gen.device)
    params = {
        "embed": (emb * (1.0 / cfg.d_model ** 0.5)).to(cfg.dtype),
        "stack": ST.init_stack(gen, cfg),
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=gen.device),
    }
    if cfg.family == "encdec":
        params["enc_stack"] = ST.init_stack(gen, cfg, ST.encoder_plan(cfg))
        params["enc_norm"] = torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                         device=gen.device)
    return params


def _embed(params, tokens):
    # on a mesh, on each rank's rows: torch 2.11's DTensor has no rule for
    # the gradient's index_put with sharded indices
    x = batchwise(lambda tokens, table: table[tokens], (tokens,), (params["embed"],))
    return constrain(x, "data", None, None)


def _embed_with_prefix(params, cfg: ModelConfig, batch):
    x = _embed(params, batch["tokens"])
    if cfg.family == "vlm" and "patches" in batch:
        prefix = batch["patches"].to(x.dtype)
        return torch.cat([prefix, x], dim=1), prefix.shape[1]
    return x, 0


def _positions(b: int, s: int, device):
    return torch.arange(s, device=device)[None].expand(b, s)


def encode(params, cfg: ModelConfig, frames, *, impl="kernel"):
    """The whisper encoder over frame embeddings (B, F, d): per layer
    rms_norm -> non-causal self-attention with RoPE at positions 0..F-1 ->
    rms_norm -> MLP, then ``enc_norm``."""
    x = frames.to(cfg.dtype)
    pos = _positions(x.shape[0], x.shape[1], x.device)
    for p in params["enc_stack"]:
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        a, _ = L.attn_block(p["attn"], h, pos, cfg.rope_theta, causal=False, impl=impl)
        x = x + a
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _encoder_output(params, cfg: ModelConfig, batch, impl):
    if cfg.family != "encdec":
        return None
    if "frames" not in batch:
        raise KeyError(f"{cfg.arch_id} is an encoder-decoder model: its batch needs "
                       "'frames' (B, F, d_model), the encoder's frame embeddings")
    return encode(params, cfg, batch["frames"], impl=impl)


def forward(params, cfg: ModelConfig, batch, *, impl="kernel", moe_impl="einsum",
            remat=False):
    """Full-sequence forward; returns (the final-normed hidden states past
    the prefix, aux).  ``remat`` recomputes each decoder layer in the
    backward pass."""
    enc_out = _encoder_output(params, cfg, batch, impl)
    x, n_prefix = _embed_with_prefix(params, cfg, batch)
    b, s = x.shape[:2]
    x, _, aux = ST.apply_stack(params["stack"], cfg, x, _positions(b, s, x.device),
                               impl=impl, moe_impl=moe_impl, enc_out=enc_out,
                               mode="train", remat=remat)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, n_prefix:], aux


def logits(params, cfg: ModelConfig, hidden):
    return constrain(hidden @ params["embed"].T, "data", None, "model")


def prefill(params, cfg: ModelConfig, batch, *, impl="kernel", moe_impl="einsum",
            capacity: Optional[int] = None):
    """Process the prompt; returns (hidden_last (B, d), caches, prompt_len)."""
    enc_out = _encoder_output(params, cfg, batch, impl)
    x, _ = _embed_with_prefix(params, cfg, batch)
    b, s = x.shape[:2]
    x, caches, _ = ST.apply_stack(params["stack"], cfg, x, _positions(b, s, x.device),
                                  impl=impl, moe_impl=moe_impl, enc_out=enc_out,
                                  mode="prefill", capacity=capacity if capacity else s)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, -1], caches, s


def decode_step(params, cfg: ModelConfig, caches, cache_len: int, tokens, *,
                impl="kernel", moe_impl="einsum"):
    """tokens: (B, 1) integer tensor; cache_len: the current context length.

    Returns (logits (B, V), caches).  Attention layers update their KV
    caches in place and cross-attention reads its ``xk``/``xv`` as prefill
    left them; Mamba2 layers return a new conv window and state."""
    x = _embed(params, tokens)
    x, caches, _ = ST.apply_stack(params["stack"], cfg, x, None, impl=impl,
                                  moe_impl=moe_impl, caches=caches,
                                  cache_len=cache_len, mode="decode")
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return constrain((x @ params["embed"].T)[:, 0], "data", "model"), caches


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device: D.DeviceLike = None):
    enc_len = cfg.encoder_seq if cfg.family == "encdec" else 0
    return ST.init_cache(cfg, batch, capacity, D.resolve(device), enc_len)
