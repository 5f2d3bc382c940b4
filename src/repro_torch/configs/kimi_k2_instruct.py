"""kimi-k2-instruct [moe] -- Kimi-K2-Instruct as published: latent attention
(MLA) with YaRN RoPE, one leading dense layer, then 60 layers of 384
sigmoid-routed experts (DeepSeek-V3's noaux_tc) top-8 plus one shared expert.

[hf:moonshotai/Kimi-K2-Instruct config.json] 61L d_model=7168 64H,
q_lora_rank 1536, kv_lora_rank 512, qk 128 + 64 RoPE, v 128, rope_theta
50000, YaRN factor 32 over 4096 positions (beta_fast 1, beta_slow 1,
mscale 1, mscale_all_dim 1); first_k_dense_replace 1 with a SwiGLU of 18432;
384 experts of 2048, 8 a token, routed_scaling_factor 2.827, n_group and
topk_group 1; vocab 163840, untied embeddings, rms_norm_eps 1e-6.  The
reference package's ``kimi-k2-1t-a32b`` is a GQA approximation of the same
model (``kimi_k2_1t_a32b.py``); this one is not among ``ARCH_IDS``.
"""
import dataclasses

import torch

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, YarnConfig

ARCH_ID = "kimi-k2-instruct"


def full() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=64,
        head_dim=192,                 # q and k: 128 + 64 RoPE dims; v has 128
        d_ff=18_432,                  # the leading dense layer's SwiGLU
        vocab=163_840,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128),
        rope_theta=50_000.0,
        rope_scaling=YarnConfig(factor=32.0, original_max_position_embeddings=4096,
                                beta_fast=1.0, beta_slow=1.0, mscale=1.0,
                                mscale_all_dim=1.0),
        first_k_dense=1,
        moe=MoEConfig(
            n_experts=384,
            top_k=8,
            d_ff_expert=2048,
            n_shared_experts=1,
            d_ff_shared=2048,
            router="sigmoid",
            routed_scale=2.827,
        ),
        norm_eps=1e-6,
        tie_embeddings=False,
        citation="hf:moonshotai/Kimi-K2-Instruct",
    )


def reduced(n_layers: int = 3, d_model: int = 256) -> ModelConfig:
    """A CPU-sized copy: one dense layer and two MoE layers of 16 experts
    top-4, holding the 4 of expert-parallel rank 0 of 4; small ranks, and
    the published head dims (192 / 128, the pair K1 instantiates) and
    YaRN."""
    return dataclasses.replace(
        full(),
        n_layers=n_layers,
        d_model=d_model,
        n_heads=4,
        n_kv_heads=4,
        d_ff=2 * d_model,
        vocab=512,
        mla=MLAConfig(q_lora_rank=96, kv_lora_rank=64, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128),
        moe=MoEConfig(
            n_experts=16,
            top_k=4,
            d_ff_expert=d_model // 2,
            n_shared_experts=1,
            d_ff_shared=d_model // 2,
            router="sigmoid",
            routed_scale=2.827,
            ep_rank=0,
            ep_size=4,
        ),
        dtype=torch.float32,
    )
