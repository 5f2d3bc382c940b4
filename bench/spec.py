"""Read the benchmark's data files: configurations, traffic mixes and the
cells of ``BENCHMARK.json``; and find a stage's layout by name.  Plain
Python: the reference and the weight maker import this, and neither may
import the program.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
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
# a stage's layout, by the name its configuration gives
# ---------------------------------------------------------------------------
PARTS = ("layouts", "reference")


def layout(st: dict):
    """The module ``bench/layouts/<layout>.py`` of the stage's layout: its
    weights, the program's tree and config over them, its counts, its tiny
    copy."""
    return _part(st, "layouts")


def reference(st: dict):
    """The module ``bench/reference/<layout>.py``: the layout's plain
    float32 ``forward``."""
    return _part(st, "reference")


def _part(st: dict, part: str):
    name = st.get("layout")
    mod = sys.modules.get(f"bench.{part}.{name}")
    if mod is not None:
        return mod
    if not (isinstance(name, str) and name.isidentifier()):
        raise LookupError(f"stage {st.get('arch_id')!r} names no layout: give it the key 'layout', "
                          f"a Python identifier, and add bench/layouts/<layout>.py and "
                          f"bench/reference/<layout>.py")
    missing = [f"bench/{p}/{name}.py" for p in PARTS
               if importlib.util.find_spec(f"bench.{p}.{name}") is None]
    if missing:
        raise LookupError(f"stage {st.get('arch_id')!r} has the layout {name!r}: add "
                          f"{' and '.join(missing)}")
    return importlib.import_module(f"bench.{part}.{name}")
