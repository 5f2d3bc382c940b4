"""The decoder layout: a stack of pre-norm blocks, each a mixer (GQA
attention with RoPE, or the Mamba2 mixer where a hybrid's attention period
says so) followed by a feed-forward (a SwiGLU MLP, or a softmax top-k MoE
with capacity where the expert period says so).  Phi-3's text backbone and
Yi are dense stages of it, Jamba a hybrid one.

Everything of the benchmark that depends on this architecture, apart from
its plain reference (``bench/reference/decoder.py``): the layer pattern,
the weights' names, shapes and initialisers (``bench/weights.py`` draws
them), the program's parameter tree and ``ModelConfig`` over them, the
model FLOPs of a served batch, the least time of each kernel call it
makes, and its tiny copy for the CPU tests.  The program is imported
inside ``port_config`` only.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import torch

from bench import roofline


# ---------------------------------------------------------------------------
# one stage's layer pattern, from its configuration's keys
# ---------------------------------------------------------------------------
def is_attn(st: dict, i: int) -> bool:
    if st["family"] != "hybrid":
        return True
    return i % st["attn_layer_period"] == st["attn_layer_offset"]


def is_moe(st: dict, i: int) -> bool:
    if "num_experts" not in st:
        return False
    return i % st["expert_layer_period"] == st["expert_layer_offset"]


def mamba_dims(st: dict) -> dict:
    d = st["hidden_size"]
    din = st["mamba_expand"] * d
    gn = st["mamba_n_groups"] * st["mamba_d_state"]
    return {"d_inner": din, "gn": gn, "heads": din // st["mamba_head_dim"],
            "conv_dim": din + 2 * gn}


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
def shapes(st: dict) -> List[Tuple[str, tuple, str, int]]:
    """(name, shape, init, fan_in) for every weight of a stage, in order.
    init: dense, embed, norm, conv, zero (bf16); router, a_log, ones,
    zero32 (f32)."""
    d, v = st["hidden_size"], st["vocab_size"]
    out = [("embed_tokens", (v, d), "embed", d)]
    for i in range(st["num_hidden_layers"]):
        p = f"layers.{i}."
        out.append((p + "input_layernorm", (d,), "norm", 0))
        if is_attn(st, i):
            h, kv, hd = st["num_attention_heads"], st["num_key_value_heads"], st["head_dim"]
            out += [(p + "self_attn.q_proj", (d, h * hd), "dense", d),
                    (p + "self_attn.k_proj", (d, kv * hd), "dense", d),
                    (p + "self_attn.v_proj", (d, kv * hd), "dense", d),
                    (p + "self_attn.o_proj", (h * hd, d), "dense", h * hd)]
        else:
            m = mamba_dims(st)
            din, nh, cd = m["d_inner"], m["heads"], m["conv_dim"]
            out += [(p + "mamba.in_proj", (d, 2 * din + 2 * m["gn"] + nh), "dense", d),
                    (p + "mamba.conv1d.weight", (cd, st["mamba_d_conv"]), "conv", 0),
                    (p + "mamba.conv1d.bias", (cd,), "zero", 0),
                    (p + "mamba.A_log", (nh,), "a_log", 0),
                    (p + "mamba.D", (nh,), "ones", 0),
                    (p + "mamba.dt_bias", (nh,), "zero32", 0),
                    (p + "mamba.norm", (din,), "norm", 0),
                    (p + "mamba.out_proj", (din, d), "dense", din)]
        out.append((p + "post_attention_layernorm", (d,), "norm", 0))
        if is_moe(st, i):
            e, f = st["num_experts"], st["expert_intermediate_size"]
            out += [(p + "moe.router", (d, e), "router", d),
                    (p + "moe.experts.gate_proj", (e, d, f), "dense", d),
                    (p + "moe.experts.up_proj", (e, d, f), "dense", d),
                    (p + "moe.experts.down_proj", (e, f, d), "dense", f)]
        else:
            f = st["intermediate_size"]
            out += [(p + "mlp.gate_proj", (d, f), "dense", d),
                    (p + "mlp.up_proj", (d, f), "dense", d),
                    (p + "mlp.down_proj", (f, d), "dense", f)]
    out.append(("norm", (d,), "norm", 0))
    return out


def _a_log(shape, fan_in, gen, device):
    return torch.log(torch.rand(shape, generator=gen, device=device) * 15.0 + 1.0)


# the f32 kinds that bench/weights.py does not know, (shape, fan_in,
# generator, device) -> tensor, drawn in shapes' order from its generator
F32_INIT = {"a_log": _a_log}


def to_port(w: Dict[str, torch.Tensor], st: dict) -> dict:
    """The program's parameter tree (``repro_torch.models.model``'s layout)
    over views of ``w``."""
    d = st["hidden_size"]
    stack = []
    for i in range(st["num_hidden_layers"]):
        p = f"layers.{i}."
        lay = {"ln1": w[p + "input_layernorm"], "ln2": w[p + "post_attention_layernorm"]}
        if is_attn(st, i):
            h, kv, hd = st["num_attention_heads"], st["num_key_value_heads"], st["head_dim"]
            lay["attn"] = {"wq": w[p + "self_attn.q_proj"].view(d, h, hd),
                           "wk": w[p + "self_attn.k_proj"].view(d, kv, hd),
                           "wv": w[p + "self_attn.v_proj"].view(d, kv, hd),
                           "wo": w[p + "self_attn.o_proj"].view(h, hd, d)}
        else:
            q = p + "mamba."
            lay["ssm"] = {"in_proj": w[q + "in_proj"], "conv_w": w[q + "conv1d.weight"],
                          "conv_b": w[q + "conv1d.bias"], "A_log": w[q + "A_log"],
                          "D": w[q + "D"], "dt_bias": w[q + "dt_bias"],
                          "norm": w[q + "norm"], "out_proj": w[q + "out_proj"]}
        if is_moe(st, i):
            q = p + "moe."
            lay["moe"] = {"router": w[q + "router"], "w_gate": w[q + "experts.gate_proj"],
                          "w_in": w[q + "experts.up_proj"], "w_out": w[q + "experts.down_proj"]}
        else:
            lay["mlp"] = {"w_gate": w[p + "mlp.gate_proj"], "w_in": w[p + "mlp.up_proj"],
                          "w_out": w[p + "mlp.down_proj"]}
        stack.append(lay)
    return {"embed": w["embed_tokens"], "stack": stack, "final_norm": w["norm"]}


def port_config(st: dict, dtype=torch.bfloat16):
    from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig
    kw = dict(arch_id=st["arch_id"], family=st["family"], n_layers=st["num_hidden_layers"],
              d_model=st["hidden_size"], n_heads=st["num_attention_heads"],
              n_kv_heads=st["num_key_value_heads"], head_dim=st["head_dim"],
              d_ff=st["intermediate_size"], vocab=st["vocab_size"],
              rope_theta=st["rope_theta"], norm_eps=st["rms_norm_eps"], dtype=dtype)
    if st["family"] == "hybrid":
        kw.update(attn_every=st["attn_layer_period"], attn_offset=st["attn_layer_offset"],
                  ssm=SSMConfig(d_state=st["mamba_d_state"], head_dim=st["mamba_head_dim"],
                                expand=st["mamba_expand"], d_conv=st["mamba_d_conv"],
                                n_groups=st["mamba_n_groups"],
                                chunk_size=st["mamba_chunk_size"]))
    if "num_experts" in st:
        kw["moe"] = MoEConfig(n_experts=st["num_experts"], top_k=st["num_experts_per_tok"],
                              d_ff_expert=st["expert_intermediate_size"],
                              capacity_factor=st["capacity_factor"],
                              every=st["expert_layer_period"],
                              offset=st["expert_layer_offset"])
    return ModelConfig(**kw)


# ---------------------------------------------------------------------------
# model FLOPs (bench/roofline.py says what is counted)
# ---------------------------------------------------------------------------
def _layer_flops(st: dict, i: int, keys: int) -> float:
    """One token through layer i, attending over ``keys`` positions.
    Attention counts QK^T and PV over the keys; the Mamba2 scan its
    recurrent form (state update and read-out, 4 H P N a token); a MoE
    layer its router and the top-k experts of each token."""
    d = st["hidden_size"]
    f = 0.0
    if is_attn(st, i):
        h, kv, hd = st["num_attention_heads"], st["num_key_value_heads"], st["head_dim"]
        f += 2.0 * d * (h + 2 * kv) * hd + 2.0 * h * hd * d + 4.0 * h * hd * keys
    else:
        m = mamba_dims(st)
        din, nh = m["d_inner"], m["heads"]
        f += 2.0 * d * (2 * din + 2 * m["gn"] + nh) + 2.0 * din * d
        f += 2.0 * m["conv_dim"] * st["mamba_d_conv"]
        f += 4.0 * nh * st["mamba_head_dim"] * st["mamba_d_state"]
    if is_moe(st, i):
        f += 2.0 * d * st["num_experts"]
        f += st["num_experts_per_tok"] * 6.0 * d * st["expert_intermediate_size"]
    else:
        f += 6.0 * d * st["intermediate_size"]
    return f


def token_flops(st: dict, keys: int) -> float:
    """One token through every layer at context ``keys``, no logits."""
    return sum(_layer_flops(st, i, keys) for i in range(st["num_hidden_layers"]))


def batch_flops(st: dict, b: int, prompt: int, gen: int) -> float:
    """token_flops is linear in the keys, so the sums over positions are
    taken in closed form."""
    head = 2.0 * st["hidden_size"] * st["vocab_size"]
    base = token_flops(st, 0)
    per_key = token_flops(st, 1) - base
    pre = prompt * base + per_key * prompt * (prompt + 1) / 2 + head
    keys = sum(prompt + j + 1 for j in range(gen - 1))
    dec = (gen - 1) * (base + head) + per_key * keys
    return b * (pre + dec)


# ---------------------------------------------------------------------------
# the port's kernel calls a served batch makes, from the configuration
# ---------------------------------------------------------------------------
def kernel_bounds(st: dict, b: int, prompt: int, gen: int) -> dict:
    """Least time (ms) of every K1, K2 and K3 call one batch of a stage
    makes: K1 once a attention layer over the prompt, K2 once a attention
    layer in each of ``gen`` decode steps over a cache of prompt + gen
    slots, K3 once a Mamba2 layer over the prompt."""
    out = {"attn_prefill": 0.0, "attn_decode": 0.0, "ssd": 0.0}
    cap = prompt + gen
    for i in range(st["num_hidden_layers"]):
        if is_attn(st, i):
            h, kv, hd = st["num_attention_heads"], st["num_key_value_heads"], st["head_dim"]
            out["attn_prefill"] += roofline.flash_bound(b, prompt, prompt, h, kv, hd, "bf16")[0]
            for j in range(gen):
                out["attn_decode"] += roofline.decode_bound(h, kv, hd, cap, [prompt + j + 1] * b,
                                                            "bf16")[0]
        else:
            m = mamba_dims(st)
            out["ssd"] += roofline.ssd_bound(b, prompt, m["heads"], st["mamba_head_dim"],
                                             st["mamba_n_groups"], st["mamba_d_state"],
                                             st["mamba_chunk_size"], "bf16")[0]
    return out


# ---------------------------------------------------------------------------
# the CPU tests' copy
# ---------------------------------------------------------------------------
def tiny(st: dict, d: int = 0) -> dict:
    """Width 256 and 4096 ids; dense stages keep 4 layers, the hybrid its
    16 (both periods) with 8 experts.  So cut, the fp8 control still reads
    above each cell's limit on every seed tried."""
    hybrid = st["family"] == "hybrid"
    d = d or 256
    st = copy.deepcopy(st)
    st.update(hidden_size=d, num_attention_heads=4, head_dim=32, intermediate_size=2 * d,
              vocab_size=4096)
    st["num_key_value_heads"] = 2 if st["num_key_value_heads"] < st["num_attention_heads"] else 4
    if hybrid:
        st.update(num_experts=8, expert_intermediate_size=d, mamba_head_dim=32,
                  mamba_chunk_size=16)
    else:
        st["num_hidden_layers"] = 4
    return st
