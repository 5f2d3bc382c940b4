"""Read the benchmark's data files: configurations, traffic mixes and the
cells of ``BENCHMARK.json``.  Plain Python: the reference and the weight
maker import this, and neither may import the program.
"""
from __future__ import annotations

import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    for c in benchmark()["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


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
