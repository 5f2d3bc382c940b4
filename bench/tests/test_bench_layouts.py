"""Each stage's layout: what the benchmark reads from it is what it read
before the layouts (``bench/tests/pinned.*``, written by ``collect_config``
and ``collect_cell`` below with the calls of the commit before them), a
layout that only a test knows is taken from end to end, and a stage whose
layout has no files says which to add."""
import hashlib
import importlib
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

from bench import harness, spec, weights
from bench.tests.tiny import tiny_cell

BENCH = Path(__file__).resolve().parents[1]
PINNED = json.loads((BENCH / "tests" / "pinned.json").read_text())
TINY_SEED, ROWS, PROMPT, N_OUT = 7, 2, 12, 2


def _json(x):
    return json.loads(json.dumps(x))


def _sha(t):
    return hashlib.sha256(t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()).hexdigest()


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{pre}{k}.")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{pre}{i}.")]
    return [[pre, list(tree.shape), str(tree.dtype)]]


def collect_config(name: str):
    """Of each stage at published widths: its weights (name, shape, kind,
    fan-in), their bytes and the program's ``ModelConfig``; of its tiny copy:
    the stage, the SHA-256 of each weight at ``TINY_SEED``, the program's
    tree's leaves and ``ModelConfig``, and the float32 reference's logits on
    one fixed batch, on one thread (a CPU product's sums split by thread)."""
    stages, logits = [], {}
    for k, st in enumerate(spec.config(name)["stages"]):
        lay = spec.layout(st)
        t = lay.tiny(st)
        w = weights.make_weights(t, TINY_SEED, k, "cpu")
        batch = torch.randint(0, t["vocab_size"], (ROWS, PROMPT + N_OUT - 1),
                              generator=torch.Generator().manual_seed(k))
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            with torch.inference_mode():
                logits[f"{name}.{k}"] = spec.reference(t).forward(w, t, [batch], PROMPT, N_OUT)[0]
        finally:
            torch.set_num_threads(threads)
        stages.append({
            "shapes": [[n, list(s), kind, fan] for n, s, kind, fan in lay.shapes(st)],
            "n_bytes": weights.n_bytes(st),
            "port_config": repr(lay.port_config(st, torch.bfloat16)),
            "tiny": {key: v for key, v in t.items() if key != "layout"},
            "tiny_weights": {n: _sha(v) for n, v in w.items()},
            "tiny_tree": _leaves(lay.to_port(w, t)),
            "tiny_port_config": repr(lay.port_config(t, torch.float32))})
    return stages, logits


def collect_cell(name: str) -> list:
    """Each stage's ``batch_flops`` and ``kernel_bounds`` for batch sizes 1
    to the cell's ``batch_size`` at its lengths."""
    cell = harness.load_cell(name)
    return [[{"b": b, "batch_flops": spec.layout(st).batch_flops(st, b, prompt, gen),
              "kernel_bounds": spec.layout(st).kernel_bounds(st, b, prompt, gen)}
             for b in range(1, cell.traffic["batch_size"] + 1)]
            for st, (prompt, gen) in zip(cell.stages, cell.lengths())]


@pytest.mark.parametrize("config", sorted(PINNED["configs"]))
def test_configuration_reads_what_it_read_before_the_layouts(config):
    got, logits = collect_config(config)
    want = PINNED["configs"][config]
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(_json(got), want)):
        for key in w:
            assert g[key] == w[key], (config, k, key)
    pinned = torch.load(BENCH / "tests" / "pinned.pt", weights_only=True)
    for key, lg in logits.items():
        assert torch.equal(lg, pinned[key]), key


@pytest.mark.parametrize("cell", sorted(PINNED["cells"]))
def test_cell_counts_what_it_counted_before_the_layouts(cell):
    assert _json(collect_cell(cell)) == PINNED["cells"][cell]


def _unseen(tmp_path, monkeypatch, name, parts=spec.PARTS):
    """Copies of the decoder layout's files under ``name`` in a directory
    the packages ``bench.layouts`` and ``bench.reference`` search."""
    for part in parts:
        d = tmp_path / part
        d.mkdir()
        shutil.copy(BENCH / part / "decoder.py", d / f"{name}.py")
    for part in spec.PARTS:
        pkg = importlib.import_module(f"bench.{part}")
        monkeypatch.setattr(pkg, "__path__", [*pkg.__path__, str(tmp_path / part)])


def test_a_layout_only_a_test_knows_is_built_served_and_checked(tmp_path, monkeypatch):
    name = "unseen_decoder"
    _unseen(tmp_path, monkeypatch, name)
    cell = tiny_cell("vlm-classify.backlog")
    for st in cell.stages:
        st["layout"] = name
    try:
        ws, engine = harness.build(cell, 5, "cpu")
        harness.warm_up(cell, engine, "cpu")
        run, cap = harness.run_window(cell, engine, 5, 1.0, harness.Spans(False), "cpu")
        got = harness.check(cell, ws, run, cap, 5, "cpu")
        for part in spec.PARTS:
            assert sys.modules[f"bench.{part}.{name}"].__file__ == str(tmp_path / part / f"{name}.py")
    finally:
        for part in spec.PARTS:
            sys.modules.pop(f"bench.{part}.{name}", None)
    assert got["batches"] > 0 and sum(r.failed for r in run.recs) == 0
    for k, lim in cell.traffic["limits"].items():
        assert got[k] <= lim, (k, got[k])


@pytest.mark.parametrize("layout, files", [
    (None, ["bench/layouts/<layout>.py", "bench/reference/<layout>.py"]),
    ("no_such_layout", ["bench/layouts/no_such_layout.py", "bench/reference/no_such_layout.py"]),
    ("half_a_layout", ["bench/reference/half_a_layout.py"]),
])
def test_a_stage_without_its_layout_s_files_names_them(layout, files, tmp_path, monkeypatch):
    _unseen(tmp_path, monkeypatch, "half_a_layout", parts=("layouts",))
    st = dict(spec.config("vlm-classify")["stages"][0])
    del st["layout"]
    if layout:
        st["layout"] = layout
    try:
        for find in (spec.layout, spec.reference, lambda s: weights.make_weights(s, 1, 0, "cpu")):
            with pytest.raises(LookupError) as e:
                find(st)
            assert all(f in str(e.value) for f in files), str(e.value)
            assert "bench/layouts/half_a_layout.py" not in str(e.value)
    finally:
        sys.modules.pop("bench.layouts.half_a_layout", None)
