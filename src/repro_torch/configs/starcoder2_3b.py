"""starcoder2-3b [dense] — GQA (kv=2), RoPE, sliding-window 4096 (all layers).

[arXiv:2402.19173] 30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
"""
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig

ARCH_ID = "starcoder2-3b"


def full() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        head_dim=128,
        d_ff=12288,
        vocab=49_152,
        sliding_window=4096,
        global_every=0,             # all layers sliding-window
        rope_theta=100_000.0,
        mlp_gated=False,
        citation="arXiv:2402.19173",
    )


def reduced(n_layers: int = 2, d_model: int = 256) -> ModelConfig:
    return dataclasses.replace(
        full(),
        n_layers=n_layers,
        d_model=d_model,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=4 * d_model,
        vocab=512,
        sliding_window=64,
        dtype=torch.float32,
    )


def variant_family():
    return [
        (f"{ARCH_ID}-n", reduced(2, 128), 51.0),
        (f"{ARCH_ID}-s", reduced(2, 256), 60.4),
        (f"{ARCH_ID}-m", reduced(4, 384), 65.9),
    ]
