"""yi-34b [dense] — llama-architecture GQA.

[arXiv:2403.04652] 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
"""
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig

ARCH_ID = "yi-34b"


def full() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="dense",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab=64_000,
        rope_theta=5_000_000.0,
        citation="arXiv:2403.04652",
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
        dtype=torch.float32,
    )


def variant_family():
    # plays the role of the paper's classifier family (Table 8, ResNets).
    return [
        (f"{ARCH_ID}-n", reduced(2, 128), 69.75),
        (f"{ARCH_ID}-s", reduced(2, 256), 76.13),
        (f"{ARCH_ID}-m", reduced(4, 384), 78.31),
    ]
