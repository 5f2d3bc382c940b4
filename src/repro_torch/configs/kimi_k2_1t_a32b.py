"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE, 384 experts top-8.

[arXiv:2501.kimi2, paper-table config] 61L d_model=7168 64H (GQA kv=8)
d_ff_expert=2048 vocab=163840, MoE 384e top-8 + 1 shared expert.
"""
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig

ARCH_ID = "kimi-k2-1t-a32b"


def full() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=0,                       # every layer routed (+1 shared expert)
        vocab=163_840,
        moe=MoEConfig(
            n_experts=384,
            top_k=8,
            d_ff_expert=2048,
            n_shared_experts=1,
            d_ff_shared=2048,
            capacity_factor=1.25,
        ),
        rope_theta=50_000.0,
        citation="arXiv:2501.kimi2",
    )


def reduced(n_layers: int = 2, d_model: int = 256) -> ModelConfig:
    return dataclasses.replace(
        full(),
        n_layers=n_layers,
        d_model=d_model,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        vocab=512,
        moe=MoEConfig(
            n_experts=4,
            top_k=2,
            d_ff_expert=2 * d_model,
            n_shared_experts=1,
            d_ff_shared=2 * d_model,
            capacity_factor=2.0,
        ),
        dtype=torch.float32,
    )


def variant_family():
    return [
        (f"{ARCH_ID}-n", reduced(2, 128), 62.5),
        (f"{ARCH_ID}-s", reduced(2, 256), 70.1),
        (f"{ARCH_ID}-m", reduced(4, 384), 76.0),
    ]
