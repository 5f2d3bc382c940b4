"""starcoder2-15b [dense] — GQA (kv=4), RoPE, sliding-window 4096 (all layers).

[arXiv:2402.19173] 40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.
"""
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig

ARCH_ID = "starcoder2-15b"


def full() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="dense",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        head_dim=128,
        d_ff=24576,
        vocab=49_152,
        sliding_window=4096,
        global_every=0,
        rope_theta=100_000.0,
        mlp_gated=False,
        citation="arXiv:2402.19173",
    )


def reduced(n_layers: int = 2, d_model: int = 256) -> ModelConfig:
    return dataclasses.replace(
        full(),
        n_layers=n_layers,
        d_model=d_model,
        n_heads=8,
        n_kv_heads=2,
        head_dim=32,
        d_ff=4 * d_model,
        vocab=512,
        sliding_window=64,
        dtype=torch.float32,
    )


def variant_family():
    return [
        (f"{ARCH_ID}-n", reduced(2, 128), 56.2),
        (f"{ARCH_ID}-s", reduced(2, 256), 66.0),
        (f"{ARCH_ID}-m", reduced(4, 384), 72.8),
    ]
