"""What decides `correct`: the comparison passes the program, and fails the
fp8 control and a run whose timed path is broken underneath.  Tiny copies
of the cells on the CPU, with each cell's own limits; the harness's look
for a card is skipped by calling it with the CPU."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bench import harness, spec
from bench.tests.tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _run(cell, seed=11):
    return harness.run(cell.name, seed, 2.0, False, device="cpu", cell=cell,
                       log=lambda *a, **k: None)


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_fp8_control_fails(name):
    cell = tiny_cell(name)
    ws, engine = harness.build(cell, 5, "cpu")
    harness.warm_up(cell, engine, "cpu")
    run, cap = harness.run_window(cell, engine, 5, 2.0, harness.Spans(False), "cpu")
    got = harness.check(cell, ws, run, cap, 5, "cpu", control=True)
    for k, lim in cell.traffic["limits"].items():
        assert got[k] <= lim, (k, got[k])
    assert any(got["control"][k] > lim for k, lim in cell.traffic["limits"].items()), got


@pytest.fixture
def stale_state(monkeypatch):
    """Decode steps that return their caches unchanged."""
    from repro_torch.models import model as M
    real = M.decode_step

    def decode_step(params, cfg, caches, cache_len, tokens, **kw):
        keep = [{k: v.clone() for k, v in c.items()} for c in caches]
        lg, _ = real(params, cfg, caches, cache_len, tokens, **kw)
        return lg, keep
    monkeypatch.setattr(M, "decode_step", decode_step)


@pytest.fixture
def half_batch(monkeypatch):
    """A stage serves the first half of its batch and hands those rows'
    tokens to the rest."""
    from repro_torch.serving.engine import StageServer
    real = StageServer.process

    def process(self, tokens):
        b = tokens.shape[0]
        out, lat = real(self, tokens[: (b + 1) // 2])
        return np.concatenate([out, out[: b - out.shape[0]]]), lat
    monkeypatch.setattr(StageServer, "process", process)


@pytest.fixture
def altered_token(monkeypatch):
    """Each row's fourth generated token altered where the stage produces
    it."""
    from repro_torch.serving.engine import StageServer
    real = StageServer.process

    def process(self, tokens):
        out, lat = real(self, tokens)
        out = out.copy()
        out[:, 3] = (out[:, 3] + 1) % self.config.vocab
        return out, lat
    monkeypatch.setattr(StageServer, "process", process)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["stale_state", "half_batch", "altered_token"])
def test_a_broken_timed_path_is_not_correct(name, fault, request):
    cell = tiny_cell(name)
    assert _run(cell)["correct"]
    request.getfixturevalue(fault)
    res = _run(cell)
    assert not res["correct"], res["checks"]


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "bench/run.py", "--workload", "vlm-classify.backlog", "--seed",
           "2147483700", "--seconds", "1", "--trace", "0"]
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    # a directory with BENCHMARK.json and the benchmark's files only
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
