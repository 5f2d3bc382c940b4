"""mamba2-2.7b [ssm] — attention-free SSD (state-space duality).

[arXiv:2405.21060] 64L d_model=2560 d_ff=0 vocab=50280, d_state=128,
head_dim=64, expand=2 (SSD chunked algorithm).
"""
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, SSMConfig

ARCH_ID = "mamba2-2.7b"


def full() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=50_280,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk_size=256),
        citation="arXiv:2405.21060",
    )


def reduced(n_layers: int = 2, d_model: int = 256) -> ModelConfig:
    return dataclasses.replace(
        full(),
        n_layers=n_layers,
        d_model=d_model,
        vocab=512,
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2, d_conv=4, chunk_size=32),
        dtype=torch.float32,
    )


def variant_family():
    return [
        (f"{ARCH_ID}-n", reduced(2, 128), 55.3),
        (f"{ARCH_ID}-s", reduced(2, 256), 63.8),
        (f"{ARCH_ID}-m", reduced(4, 384), 69.0),
    ]
