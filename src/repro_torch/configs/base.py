"""Model configuration dataclasses shared by every architecture family.

A ``ModelConfig`` fully describes one transformer/SSM/hybrid backbone.  Each
assigned architecture module (``src/repro_torch/configs/<arch>.py``) exports:

  * ``full()``     -- the exact published configuration (dry-run only),
  * ``reduced()``  -- a <=512 d_model, <=2 layer, <=4 expert smoke variant,
  * ``variant_family()`` -- a small accuracy/latency-spread family of reduced
    models that plays the role of the paper's "model variants" (ResNet18/50,
    YOLOv5n/m, ...) for the IPA control plane.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0          # total shared-expert hidden width
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # layers where MoE replaces the dense MLP: every `every`-th layer,
    # starting at `offset` (jamba: every 2nd; qwen2/kimi: every layer).
    every: int = 1
    offset: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    n_groups: int = 1
    chunk_size: int = 256

    def n_heads(self, d_model: int) -> int:
        return self.expand * d_model // self.head_dim

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # -- attention pattern ---------------------------------------------------
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # local-attention window, if any
    # every `global_every`-th layer uses full/global attention (gemma3 5:1);
    # 0 => all layers identical (all-global if sliding_window is None,
    # all-local otherwise).
    global_every: int = 0
    # -- hybrid (jamba): attention layer every `attn_every` layers -----------
    attn_every: int = 0
    attn_offset: int = 0
    # -- mixture of experts ---------------------------------------------------
    moe: Optional[MoEConfig] = None
    # -- state-space ----------------------------------------------------------
    ssm: Optional[SSMConfig] = None
    # -- encoder/decoder (whisper) --------------------------------------------
    n_encoder_layers: int = 0
    encoder_seq: int = 0            # precomputed frame embeddings length
    # -- vision-language ------------------------------------------------------
    n_patches: int = 0              # precomputed patch embeddings length
    # -- misc -----------------------------------------------------------------
    norm_eps: float = 1e-6
    mlp_gated: bool = True          # SwiGLU (3 mats) vs plain GELU (2 mats)
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    citation: str = ""

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def is_attn_layer(self, i: int) -> bool:
        """Hybrid archs: is layer ``i`` an attention layer (vs. SSM)?"""
        if self.family != "hybrid":
            return self.family != "ssm"
        return self.attn_every > 0 and (i % self.attn_every) == self.attn_offset

    def is_global_layer(self, i: int) -> bool:
        """Sliding-window archs: does layer ``i`` use full/global attention?"""
        if self.sliding_window is None:
            return True
        if self.global_every <= 0:
            return False
        return (i % self.global_every) == (self.global_every - 1)

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        return (i % self.moe.every) == self.moe.offset

    def layer_flags(self) -> Tuple[Tuple[bool, bool, bool], ...]:
        """(is_attn, is_global, is_moe) per layer."""
        return tuple(
            (self.is_attn_layer(i), self.is_global_layer(i), self.is_moe_layer(i))
            for i in range(self.n_layers)
        )

    # ------------------------------------------------------------------
    def n_params(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, h = self.d_model, self.head_dim_
        p = self.vocab * d                      # embedding
        if not self.tie_embeddings:
            p += self.vocab * d
        for i in range(self.n_layers):
            p += 2 * d                           # norms
            if self.is_attn_layer(i):
                p += d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h)
                p += (self.n_heads * h) * d
            elif self.ssm is not None:           # mamba2 mixer
                s = self.ssm
                din = s.d_inner(d)
                nh = s.n_heads(d)
                conv_dim = din + 2 * s.n_groups * s.d_state
                p += d * (2 * din + 2 * s.n_groups * s.d_state + nh)  # in_proj
                p += conv_dim * s.d_conv + conv_dim                    # conv
                p += 3 * nh                                            # A, D, dt_bias
                p += din                                               # norm
                p += din * d                                           # out_proj
            n_mats = 3 if self.mlp_gated else 2
            if self.is_moe_layer(i):
                m = self.moe
                p += d * m.n_experts                                   # router
                p += m.n_experts * n_mats * d * m.d_ff_expert
                if m.n_shared_experts:
                    p += n_mats * d * m.d_ff_shared
            elif self.d_ff > 0:
                p += n_mats * d * self.d_ff                            # mlp
        for _ in range(self.n_encoder_layers):
            p += d * (self.n_heads * h) * 2 + 2 * d * (self.n_kv_heads * h)
            p += (3 if self.mlp_gated else 2) * d * self.d_ff + 3 * d
            # decoder cross-attention params
            p += d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h) + (self.n_heads * h) * d + d
        p += d                                    # final norm
        return p

    def n_active_params(self) -> int:
        """Params touched per token (MoE: shared + top_k experts only)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        dense = dataclasses.replace(self, moe=None)
        p = dense.n_params()
        n_mats = 3 if self.mlp_gated else 2
        for i in range(self.n_layers):
            if self.is_moe_layer(i):
                p += self.d_model * m.n_experts                  # router
                p += m.top_k * n_mats * self.d_model * m.d_ff_expert
                if m.n_shared_experts:
                    p += n_mats * self.d_model * m.d_ff_shared
        return p


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
