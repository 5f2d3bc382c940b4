"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
Attention on every 8th layer (offset 4); MoE replaces the MLP on every 2nd
layer (offset 1); remaining layers are Mamba + dense MLP.
"""
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

ARCH_ID = "jamba-v0.1-52b"


def full() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=65_536,
        attn_every=8,
        attn_offset=4,
        moe=MoEConfig(
            n_experts=16,
            top_k=2,
            d_ff_expert=14336,
            capacity_factor=1.25,
            every=2,
            offset=1,
        ),
        ssm=SSMConfig(d_state=16, head_dim=64, expand=2, d_conv=4, chunk_size=256),
        rope_theta=10_000.0,
        citation="arXiv:2403.19887",
    )


def reduced(n_layers: int = 2, d_model: int = 256) -> ModelConfig:
    # keep the 1 attn : (n-1) mamba flavour even at depth 2
    return dataclasses.replace(
        full(),
        n_layers=n_layers,
        d_model=d_model,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=4 * d_model,
        vocab=512,
        attn_every=2,
        attn_offset=1,
        moe=MoEConfig(
            n_experts=4,
            top_k=2,
            d_ff_expert=2 * d_model,
            capacity_factor=2.0,
            every=2,
            offset=0,
        ),
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2, d_conv=4, chunk_size=32),
        dtype=torch.float32,
    )


def variant_family():
    return [
        (f"{ARCH_ID}-n", reduced(2, 128), 60.6),
        (f"{ARCH_ID}-s", reduced(2, 256), 68.9),
        (f"{ARCH_ID}-m", reduced(4, 384), 74.4),
    ]
