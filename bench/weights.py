"""The benchmark's seeded weights and the loader that hands them to the
program.

``make_weights`` keeps its own layout, one named tensor per published
weight, stored (fan_in, fan_out) so that ``x @ w`` needs no transpose.
Every bf16 tensor is a view into one flat buffer that a few ``normal_``
calls fill on the device from a ``torch.Generator`` seeded from the run's
seed and the stage's index; each tensor is then scaled in place.  The few
f32 tensors (router, ``A_log``) are drawn one by one: they are small.
``to_port`` arranges views of the same tensors into the parameter tree
that ``StageServer(params_by_variant=...)`` takes; it copies nothing.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from bench import spec

CHUNK = 1 << 30          # elements a normal_ call


def shapes(st: dict) -> List[Tuple[str, tuple, str, int]]:
    """(name, shape, init, fan_in) for every weight of a stage, in order.
    init: dense, embed, norm, conv, zero (bf16); router, a_log, ones,
    zero32 (f32)."""
    d, v = st["hidden_size"], st["vocab_size"]
    out = [("embed_tokens", (v, d), "embed", d)]
    for i in range(st["num_hidden_layers"]):
        p = f"layers.{i}."
        out.append((p + "input_layernorm", (d,), "norm", 0))
        if spec.is_attn(st, i):
            h, kv, hd = st["num_attention_heads"], st["num_key_value_heads"], st["head_dim"]
            out += [(p + "self_attn.q_proj", (d, h * hd), "dense", d),
                    (p + "self_attn.k_proj", (d, kv * hd), "dense", d),
                    (p + "self_attn.v_proj", (d, kv * hd), "dense", d),
                    (p + "self_attn.o_proj", (h * hd, d), "dense", h * hd)]
        else:
            m = spec.mamba_dims(st)
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
        if spec.is_moe(st, i):
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


F32_INITS = ("router", "a_log", "ones", "zero32")


def n_bytes(st: dict, dtype=torch.bfloat16) -> int:
    item = torch.finfo(dtype).bits // 8
    return sum(int(np.prod(s)) * (4 if k in F32_INITS else item)
               for _, s, k, _ in shapes(st))


def stage_seed(seed: int, stage: int) -> int:
    return int(np.random.SeedSequence([seed, stage]).generate_state(1, np.uint64)[0] >> 1)


def make_weights(st: dict, seed: int, stage: int, device,
                 dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(stage_seed(seed, stage))
    sh = shapes(st)
    total = sum(int(np.prod(s)) for _, s, k, _ in sh if k not in F32_INITS)
    flat = torch.empty(total, dtype=dtype, device=device)
    for a in range(0, total, CHUNK):
        flat[a:a + CHUNK].normal_(generator=gen)
    out, off = {}, 0
    for name, s, kind, fan_in in sh:
        n = int(np.prod(s))
        if kind in F32_INITS:
            if kind == "router":
                t = torch.randn(s, generator=gen, device=device) / fan_in ** 0.5
            elif kind == "a_log":
                t = torch.log(torch.rand(s, generator=gen, device=device) * 15.0 + 1.0)
            elif kind == "ones":
                t = torch.ones(s, device=device)
            else:
                t = torch.zeros(s, device=device)
            out[name] = t
            continue
        t = flat[off:off + n].view(s)
        off += n
        if kind in ("dense", "embed"):
            t.mul_(1.0 / fan_in ** 0.5 if kind == "dense" else 1.0 / st["hidden_size"] ** 0.5)
        elif kind in ("norm", "conv"):
            t.mul_(0.1)
        elif kind == "zero":
            t.zero_()
        out[name] = t
    return out


def to_port(w: Dict[str, torch.Tensor], st: dict) -> dict:
    """The program's parameter tree (``repro_torch.models.model``'s layout)
    over views of ``w``."""
    d = st["hidden_size"]
    stack = []
    for i in range(st["num_hidden_layers"]):
        p = f"layers.{i}."
        lay = {"ln1": w[p + "input_layernorm"], "ln2": w[p + "post_attention_layernorm"]}
        if spec.is_attn(st, i):
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
        if spec.is_moe(st, i):
            q = p + "moe."
            lay["moe"] = {"router": w[q + "router"], "w_gate": w[q + "experts.gate_proj"],
                          "w_in": w[q + "experts.up_proj"], "w_out": w[q + "experts.down_proj"]}
        else:
            lay["mlp"] = {"w_gate": w[p + "mlp.gate_proj"], "w_in": w[p + "mlp.up_proj"],
                          "w_out": w[p + "mlp.down_proj"]}
        stack.append(lay)
    return {"embed": w["embed_tokens"], "stack": stack, "final_norm": w["norm"]}
