"""phi-3-vision-4.2b [vlm] — phi3-mini text backbone + CLIP patch STUB.

[hf:microsoft/Phi-3-vision-128k-instruct] 32L d_model=3072 32H (kv=32)
d_ff=8192 vocab=32064.  ``input_specs`` supplies precomputed projected patch
embeddings (B, 576, 3072) prepended to the text tokens; the ViT/CLIP encoder
and projector are the allowed modality-frontend stub.
"""
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig

ARCH_ID = "phi-3-vision-4.2b"


def full() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="vlm",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=32_064,
        n_patches=576,
        rope_theta=10_000.0,
        citation="hf:microsoft/Phi-3-vision-128k-instruct",
    )


def reduced(n_layers: int = 2, d_model: int = 256) -> ModelConfig:
    return dataclasses.replace(
        full(),
        n_layers=n_layers,
        d_model=d_model,
        n_heads=4,
        n_kv_heads=4,
        d_ff=4 * d_model,
        vocab=512,
        n_patches=16,
        dtype=torch.float32,
    )


def variant_family():
    return [
        (f"{ARCH_ID}-n", reduced(2, 128), 61.1),
        (f"{ARCH_ID}-s", reduced(2, 256), 68.3),
        (f"{ARCH_ID}-m", reduced(4, 384), 73.6),
    ]
