"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B] 24L d_model=2048 16H (kv=16) d_ff_expert=1408
vocab=151936.
"""
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig

ARCH_ID = "qwen2-moe-a2.7b"


def full() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=0,
        vocab=151_936,
        moe=MoEConfig(
            n_experts=60,
            top_k=4,
            d_ff_expert=1408,
            n_shared_experts=4,
            d_ff_shared=4 * 1408,
            capacity_factor=1.25,
        ),
        rope_theta=1_000_000.0,
        citation="hf:Qwen/Qwen1.5-MoE-A2.7B",
    )


def reduced(n_layers: int = 2, d_model: int = 256) -> ModelConfig:
    return dataclasses.replace(
        full(),
        n_layers=n_layers,
        d_model=d_model,
        n_heads=4,
        n_kv_heads=4,
        vocab=512,
        moe=MoEConfig(
            n_experts=4,
            top_k=2,
            d_ff_expert=d_model,
            n_shared_experts=2,
            d_ff_shared=2 * d_model,
            capacity_factor=2.0,
        ),
        dtype=torch.float32,
    )


def variant_family():
    return [
        (f"{ARCH_ID}-n", reduced(2, 128), 57.9),
        (f"{ARCH_ID}-s", reduced(2, 256), 65.4),
        (f"{ARCH_ID}-m", reduced(4, 384), 71.7),
    ]
