"""The latent-attention layout (Kimi-K2-Instruct, DeepSeek-V3's design): a
stack of pre-norm blocks, each multi-head latent attention (MLA) with YaRN
RoPE followed by a feed-forward, a SwiGLU MLP in the leading
``first_k_dense_replace`` layers and after them a sigmoid-routed (noaux_tc)
MoE of routed experts plus shared experts.  A stage holds the routed experts
of one expert-parallel rank: ``n_routed_experts`` of the router's
``published_n_routed_experts``, those of rank ``expert_parallel_rank`` of
``expert_parallel_size``.

Everything of the benchmark that depends on this architecture, apart from
its plain reference (``bench/reference/mla.py``): the layer pattern, the
weights' names, shapes and initialisers (``bench/weights.py`` draws them),
the program's parameter tree and ``ModelConfig`` over them, the model FLOPs
of a served batch, the least time of each kernel call it makes, and its
tiny copy for the CPU tests.  The program is imported inside
``port_config`` only.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import torch

from bench import roofline


# ---------------------------------------------------------------------------
# one stage's layer pattern and widths, from its configuration's keys
# ---------------------------------------------------------------------------
def is_moe(st: dict, i: int) -> bool:
    return i >= st["first_k_dense_replace"] and i % st["moe_layer_freq"] == 0


def held(st: dict) -> Tuple[int, int]:
    """(first held expert, number held) of the router's experts."""
    n = st["n_routed_experts"]
    if n * st["expert_parallel_size"] != st["published_n_routed_experts"]:
        raise ValueError(f"{n} held experts x {st['expert_parallel_size']} ranks is not the "
                         f"router's {st['published_n_routed_experts']}")
    return st["expert_parallel_rank"] * n, n


def dims(st: dict) -> dict:
    return {"h": st["num_attention_heads"], "ql": st["q_lora_rank"], "kvl": st["kv_lora_rank"],
            "dn": st["qk_nope_head_dim"], "dr": st["qk_rope_head_dim"], "dv": st["v_head_dim"]}


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
def shapes(st: dict) -> List[Tuple[str, tuple, str, int]]:
    """(name, shape, init, fan_in) for every weight of a stage, in order.
    init: dense, embed, norm (bf16); router, e_bias (f32)."""
    d, v = st["hidden_size"], st["vocab_size"]
    m = dims(st)
    h, ql, kvl, dn, dr, dv = m["h"], m["ql"], m["kvl"], m["dn"], m["dr"], m["dv"]
    out = [("embed_tokens", (v, d), "embed", d)]
    for i in range(st["num_hidden_layers"]):
        p = f"layers.{i}."
        a = p + "self_attn."
        out += [(p + "input_layernorm", (d,), "norm", 0),
                (a + "q_a_proj", (d, ql), "dense", d),
                (a + "q_a_layernorm", (ql,), "norm", 0),
                (a + "q_b_proj", (ql, h * (dn + dr)), "dense", ql),
                (a + "kv_a_proj_with_mqa", (d, kvl + dr), "dense", d),
                (a + "kv_a_layernorm", (kvl,), "norm", 0),
                (a + "kv_b_proj", (kvl, h * (dn + dv)), "dense", kvl),
                (a + "o_proj", (h * dv, d), "dense", h * dv),
                (p + "post_attention_layernorm", (d,), "norm", 0)]
        if is_moe(st, i):
            e, f = st["n_routed_experts"], st["moe_intermediate_size"]
            fs = st["n_shared_experts"] * f
            q = p + "mlp."
            out += [(q + "gate", (d, st["published_n_routed_experts"]), "router", d),
                    (q + "gate.e_score_correction_bias", (st["published_n_routed_experts"],),
                     "e_bias", 0),
                    (q + "experts.gate_proj", (e, d, f), "dense", d),
                    (q + "experts.up_proj", (e, d, f), "dense", d),
                    (q + "experts.down_proj", (e, f, d), "dense", f),
                    (q + "shared_experts.gate_proj", (d, fs), "dense", d),
                    (q + "shared_experts.up_proj", (d, fs), "dense", d),
                    (q + "shared_experts.down_proj", (fs, d), "dense", fs)]
        else:
            f = st["intermediate_size"]
            out += [(p + "mlp.gate_proj", (d, f), "dense", d),
                    (p + "mlp.up_proj", (d, f), "dense", d),
                    (p + "mlp.down_proj", (f, d), "dense", f)]
    out.append(("norm", (d,), "norm", 0))
    return out


def _e_bias(shape, fan_in, gen, device):
    return torch.randn(shape, generator=gen, device=device) * 0.1


# the f32 kinds that bench/weights.py does not know, (shape, fan_in,
# generator, device) -> tensor, drawn in shapes' order from its generator
F32_INIT = {"e_bias": _e_bias}


def to_port(w: Dict[str, torch.Tensor], st: dict) -> dict:
    """The program's parameter tree (``repro_torch.models.model``'s layout,
    ``models/mla.py``'s attention) over views of ``w``."""
    d = st["hidden_size"]
    m = dims(st)
    h, ql, kvl, dn, dr, dv = m["h"], m["ql"], m["kvl"], m["dn"], m["dr"], m["dv"]
    stack = []
    for i in range(st["num_hidden_layers"]):
        p = f"layers.{i}."
        a = p + "self_attn."
        lay = {"ln1": w[p + "input_layernorm"], "ln2": w[p + "post_attention_layernorm"],
               "attn": {"wq_a": w[a + "q_a_proj"], "q_norm": w[a + "q_a_layernorm"],
                        "wq_b": w[a + "q_b_proj"].view(ql, h, dn + dr),
                        "wkv_a": w[a + "kv_a_proj_with_mqa"],
                        "kv_norm": w[a + "kv_a_layernorm"],
                        "wkv_b": w[a + "kv_b_proj"].view(kvl, h, dn + dv),
                        "wo": w[a + "o_proj"].view(h, dv, d)}}
        if is_moe(st, i):
            q = p + "mlp."
            lay["moe"] = {"router": w[q + "gate"], "bias": w[q + "gate.e_score_correction_bias"],
                          "w_gate": w[q + "experts.gate_proj"], "w_in": w[q + "experts.up_proj"],
                          "w_out": w[q + "experts.down_proj"],
                          "shared": {"w_gate": w[q + "shared_experts.gate_proj"],
                                     "w_in": w[q + "shared_experts.up_proj"],
                                     "w_out": w[q + "shared_experts.down_proj"]}}
        else:
            lay["mlp"] = {"w_gate": w[p + "mlp.gate_proj"], "w_in": w[p + "mlp.up_proj"],
                          "w_out": w[p + "mlp.down_proj"]}
        stack.append(lay)
    return {"embed": w["embed_tokens"], "stack": stack, "final_norm": w["norm"]}


def port_config(st: dict, dtype=torch.bfloat16):
    from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, YarnConfig
    if st["n_group"] != 1 or st["topk_group"] != 1 or st["scoring_func"] != "sigmoid" \
            or st["topk_method"] != "noaux_tc" or not st["norm_topk_prob"]:
        raise ValueError("the port routes sigmoid noaux_tc over one group, normalised")
    m = dims(st)
    rs = st["rope_scaling"]
    held(st)
    return ModelConfig(
        arch_id=st["arch_id"], family="moe", n_layers=st["num_hidden_layers"],
        d_model=st["hidden_size"], n_heads=m["h"], n_kv_heads=m["h"],
        head_dim=m["dn"] + m["dr"], d_ff=st["intermediate_size"], vocab=st["vocab_size"],
        mla=MLAConfig(q_lora_rank=m["ql"], kv_lora_rank=m["kvl"], qk_nope_head_dim=m["dn"],
                      qk_rope_head_dim=m["dr"], v_head_dim=m["dv"]),
        rope_theta=float(st["rope_theta"]),
        rope_scaling=YarnConfig(factor=float(rs["factor"]),
                                original_max_position_embeddings=rs[
                                    "original_max_position_embeddings"],
                                beta_fast=float(rs["beta_fast"]),
                                beta_slow=float(rs["beta_slow"]),
                                mscale=float(rs["mscale"]),
                                mscale_all_dim=float(rs["mscale_all_dim"])),
        first_k_dense=st["first_k_dense_replace"],
        moe=MoEConfig(n_experts=st["published_n_routed_experts"],
                      top_k=st["num_experts_per_tok"], d_ff_expert=st["moe_intermediate_size"],
                      n_shared_experts=st["n_shared_experts"],
                      d_ff_shared=st["n_shared_experts"] * st["moe_intermediate_size"],
                      router="sigmoid", routed_scale=float(st["routed_scaling_factor"]),
                      ep_rank=st["expert_parallel_rank"], ep_size=st["expert_parallel_size"]),
        norm_eps=st["rms_norm_eps"], dtype=dtype)


# ---------------------------------------------------------------------------
# model FLOPs (bench/roofline.py says what is counted)
# ---------------------------------------------------------------------------
def _layer_flops(st: dict, i: int, keys: int, decode: bool) -> float:
    """One token through layer i, attending over ``keys`` positions.
    Prefill's latent attention is counted in its non-absorbed form: kv_b
    on the token, then scores over dn + dr and values over dv a key, head
    by head.  Decode's in its absorbed form: the key half of kv_b on the
    query, the value half on the output, and scores (kv_lora + dr) and
    values (kv_lora) over the latent cache.  A MoE layer counts its router
    at its full width, the shared experts, and of the routed experts the
    held share of a token's top-k (top_k x held / router width: 0.5 a token
    at 24 of 384, top 8)."""
    d = st["hidden_size"]
    m = dims(st)
    h, ql, kvl, dn, dr, dv = m["h"], m["ql"], m["kvl"], m["dn"], m["dr"], m["dv"]
    f = 2.0 * d * ql + 2.0 * ql * h * (dn + dr) + 2.0 * d * (kvl + dr) + 2.0 * h * dv * d
    if decode:
        f += 2.0 * h * dn * kvl + 2.0 * h * kvl * dv + keys * 2.0 * h * (2 * kvl + dr)
    else:
        f += 2.0 * kvl * h * (dn + dv) + keys * 2.0 * h * (dn + dr + dv)
    if is_moe(st, i):
        fe = st["moe_intermediate_size"]
        _, n_held = held(st)
        f += 2.0 * d * st["published_n_routed_experts"]
        f += st["num_experts_per_tok"] * n_held / st["published_n_routed_experts"] * 6.0 * d * fe
        f += st["n_shared_experts"] * 6.0 * d * fe
    else:
        f += 6.0 * d * st["intermediate_size"]
    return f


def token_flops(st: dict, keys: int, decode: bool = False) -> float:
    """One token through every layer at context ``keys``, no logits."""
    return sum(_layer_flops(st, i, keys, decode) for i in range(st["num_hidden_layers"]))


def batch_flops(st: dict, b: int, prompt: int, gen: int) -> float:
    """token_flops is linear in the keys, so the sums over positions are
    taken in closed form; prompt positions in the non-absorbed form, the
    ``gen - 1`` decode positions in the absorbed one."""
    head = 2.0 * st["hidden_size"] * st["vocab_size"]
    base = token_flops(st, 0)
    per_key = token_flops(st, 1) - base
    pre = prompt * base + per_key * prompt * (prompt + 1) / 2 + head
    base_d = token_flops(st, 0, decode=True)
    per_key_d = token_flops(st, 1, decode=True) - base_d
    keys = sum(prompt + j + 1 for j in range(gen - 1))
    dec = (gen - 1) * (base_d + head) + per_key_d * keys
    return b * (pre + dec)


# ---------------------------------------------------------------------------
# the port's kernel calls a served batch makes, from the configuration
# ---------------------------------------------------------------------------
def kernel_bounds(st: dict, b: int, prompt: int, gen: int) -> dict:
    """Least time (ms) of the K1 calls one batch makes: once a layer over
    the prompt, at q/k head dim dn + dr and v head dim dv, 64 heads of each.
    Operations 2 x H x (dn + dr + dv) a kept (query, key) pair; bytes Q
    (dn + dr) and O (dv) over Sq, K (dn + dr) and V (dv) over Sk.
    ``roofline.flash_bound`` at one head dim hd counts 4 x H x hd a pair and
    2 x hd for each side's two tensors, so at hd = (dn + dr + dv) / 2 (160)
    it counts exactly these.  Decode calls no kernel of the port (its
    latent attention is plain products)."""
    m = dims(st)
    hd = m["dn"] + m["dr"] + m["dv"]
    if hd % 2:
        raise ValueError(f"dn + dr + dv = {hd} is odd")
    one = roofline.flash_bound(b, prompt, prompt, m["h"], m["h"], hd // 2, "bf16")[0]
    return {"mla_prefill": st["num_hidden_layers"] * one}


# ---------------------------------------------------------------------------
# the CPU tests' copy
# ---------------------------------------------------------------------------
def tiny(st: dict, d: int = 0) -> dict:
    """Width 256, 4 heads, 4096 ids, ranks 96 and 64, the published head
    dims (the pair K1 instantiates), 4 layers after the dense one; the
    router at 64 experts of 128, 4 held (rank 0 of 16), top 8 as
    published."""
    d = d or 256
    st = copy.deepcopy(st)
    st.update(hidden_size=d, num_attention_heads=4, num_key_value_heads=4, q_lora_rank=96,
              kv_lora_rank=64, intermediate_size=2 * d, moe_intermediate_size=d // 2,
              vocab_size=4096, num_hidden_layers=5, n_routed_experts=4,
              published_n_routed_experts=64)
    return st
