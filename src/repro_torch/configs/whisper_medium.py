"""whisper-medium [audio] — enc-dec transformer backbone, conv frontend STUB.

[arXiv:2212.04356] 24L(dec)+24L(enc) d_model=1024 16H (kv=16) d_ff=4096
vocab=51865.  ``input_specs`` supplies precomputed mel-frame embeddings
(B, 1500, 1024); the mel-spectrogram + conv feature extractor is the allowed
modality-frontend stub.
"""
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig

ARCH_ID = "whisper-medium"


def full() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="encdec",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab=51_865,
        n_encoder_layers=24,
        encoder_seq=1500,
        rope_theta=10_000.0,
        mlp_gated=False,
        citation="arXiv:2212.04356",
    )


def reduced(n_layers: int = 2, d_model: int = 256) -> ModelConfig:
    return dataclasses.replace(
        full(),
        n_layers=n_layers,
        n_encoder_layers=n_layers,
        d_model=d_model,
        n_heads=4,
        n_kv_heads=4,
        d_ff=4 * d_model,
        vocab=512,
        encoder_seq=48,
        dtype=torch.float32,
    )


def variant_family():
    # plays the role of the paper's audio task family (Table 9, 1-WER).
    return [
        (f"{ARCH_ID}-n", reduced(2, 128), 58.72),
        (f"{ARCH_ID}-s", reduced(2, 256), 64.88),
        (f"{ARCH_ID}-m", reduced(4, 384), 72.35),
    ]
