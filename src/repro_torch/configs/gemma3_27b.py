"""gemma3-27b [dense] — 5:1 local:global sliding-window attention, 128k ctx.

[hf:google/gemma-3-1b-pt family; 27B config] 62L d_model=5376 32H (GQA kv=16)
d_ff=21504 vocab=262144, sliding window 1024 on local layers, every 6th layer
global.
"""
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig

ARCH_ID = "gemma3-27b"


def full() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="dense",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab=262_144,
        sliding_window=1024,
        global_every=6,
        rope_theta=1_000_000.0,
        citation="hf:google/gemma-3-1b-pt",
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
        global_every=2,
        dtype=torch.float32,
    )


def variant_family():
    """(name, config, accuracy%) triplets for the IPA control plane."""
    return [
        (f"{ARCH_ID}-n", reduced(2, 128), 58.0),
        (f"{ARCH_ID}-s", reduced(2, 256), 66.5),
        (f"{ARCH_ID}-m", reduced(4, 384), 71.2),
    ]
