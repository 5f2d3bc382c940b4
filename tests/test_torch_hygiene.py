"""The port stands alone: it imports no JAX and nothing of the reference
package, keeps its kernels on the path, and its entry points do not fall
back to the CPU when no device is given."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.core import optimizer as TOPT
from repro_torch.core import paper_profiles as TPP
from repro_torch.core import predictor as TPR
from repro_torch.examples import serve_pipeline, train_variant
from repro_torch.launch import serve
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.serving.engine import StageServer
from repro_torch.training import checkpoint, data
from repro_torch.training.train import train_loop

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
# exactly the modules jax and repro, not repro_torch
FOREIGN_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
# the control plane's numpy modules, each copied from the reference
CONTROL_PLANE = tuple(f"repro_torch.{m}" for m in (
    "core.accuracy", "core.trace", "core.cluster", "core.paper_profiles", "core.optimizer",
    "core.baselines", "core.simulator", "core.simulator_legacy", "core.adapter",
    "core.study", "serving.request", "serving.batching"))


@pytest.fixture(scope="module")
def blocked_import():
    """A fresh interpreter that imports the port with jax and repro blocked."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "import repro_torch, repro_torch.kernels, repro_torch.models, "
            "repro_torch.models.moe, repro_torch.serving, repro_torch.core, "
            "repro_torch.launch.serve, repro_torch.examples.serve_pipeline, "
            "repro_torch.training, repro_torch.training.checkpoint, "
            "repro_torch.core.predictor, repro_torch.launch.train, "
            "repro_torch.examples.train_variant\n"
            f"import {', '.join(CONTROL_PLANE)}\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_with_jax_blocked(blocked_import):
    assert blocked_import.returncode == 0, blocked_import.stderr


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    found = FOREIGN_IMPORT.findall(path.read_text())
    assert not found, found


def _code_only(path, rename=False):
    """The module's AST without docstrings, with ``solve_enum``'s signature
    and body emptied (the port writes it in torch, with a ``device``) and,
    for a reference module, its ``repro.`` imports renamed to
    ``repro_torch.``."""
    text = path.read_text()
    if rename:
        text = re.sub(r"^(\s*)(from|import) repro\.", r"\1\2 repro_torch.", text, flags=re.M)
    tree = ast.parse(text)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
            if getattr(node, "name", None) == "solve_enum":
                node.args = ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                                          kw_defaults=[], defaults=[])
                node.body = [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("module", [m.split(".", 1)[1].replace(".", "/")
                                    for m in CONTROL_PLANE]
                         + ["core/pipeline", "core/queueing", "core/profiler"])
def test_control_plane_is_the_reference_code(module):
    """With the imports renamed, a copied module differs from the reference
    only in docstrings, comments and ``solve_enum``."""
    ref = ROOT / "src" / "repro" / f"{module}.py"
    assert _code_only(PORT / f"{module}.py") == _code_only(ref, rename=True)


def test_no_library_attention_or_compile_on_the_port_path():
    scanned = {}
    for path in PORT.rglob("*.py"):
        text = scanned[path.relative_to(PORT).as_posix()] = path.read_text()
        for banned in ("scaled_dot_product_attention", "torch.compile"):
            assert banned not in text, (path, banned)
    # the enc-dec code is among them: the cross-attention block, the
    # encoder, the decoder's cross layers and the launcher and example
    assert "def cross_attn_block" in scanned["models/layers.py"]
    assert "def encode" in scanned["models/model.py"]
    assert "def _cross_decode" in scanned["models/stack.py"]
    assert {"launch/serve.py", "examples/serve_pipeline.py"} <= set(scanned)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_a_device_raise_when_cuda_is_absent(no_cuda):
    cfg = TC.get_config("yi-34b", reduced=True)
    fam = TC.get_variant_family("yi-34b")[:1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StageServer("s", fam)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build_pipeline("vlm-classify", verbose=False)
    params = TM.init(cfg, device="cpu")
    params_np = {"embed": params["embed"].numpy(), "final_norm": params["final_norm"].numpy(),
                 "stack": {"blocks": ({"ln1": np.zeros((2, cfg.d_model), np.float32)},),
                           "rem": ()}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_jax(params_np, cfg)


def test_training_entry_points_without_a_device_raise_when_cuda_is_absent(no_cuda, tmp_path):
    """The launcher, the example, the train loop, checkpoint loading, the
    LSTM predictor and ``solve_enum`` ask for the card unless told
    otherwise."""
    cfg = TC.get_config("starcoder2-3b", reduced=True)
    stream = data.SyntheticStream(cfg, data.DataConfig(seq_len=8, batch_size=1))
    calls = [lambda: launch_train.main(["--arch", "starcoder2-3b", "--reduced", "--steps", "1"]),
             lambda: train_variant.main(["--steps", "1"]),
             lambda: train_loop(cfg, stream, 1, verbose=False),
             lambda: checkpoint.load(str(tmp_path / "none.npz"), cfg),
             lambda: TPR.LSTMPredictor.train(np.ones(400, np.float32), steps=1),
             lambda: TPR.lstm_params_from_jax({"w_h": np.zeros((2, 8), np.float32)}),
             lambda: TOPT.solve_enum(TPP.video(), 5.0)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("entry", [serve.main, serve_pipeline.main],
                         ids=["launch.serve", "examples.serve_pipeline"])
def test_launchers_without_a_device_raise_when_cuda_is_absent(no_cuda, monkeypatch, entry):
    """Without ``--device`` the launcher and the example ask for the card and
    raise before building anything; ``--device cpu`` gets past that check
    (tests/test_torch_serve.py runs both to the end on the CPU)."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry([])

    def built(*a, device=None, **k):
        raise StopIteration(device)
    monkeypatch.setattr(serve, "StageServer", built)
    with pytest.raises(StopIteration) as stop:
        entry(["--device", "cpu"])
    assert str(stop.value.value) == "cpu"


def test_cpu_is_explicit(no_cuda):
    cfg = TC.get_config("yi-34b", reduced=True)
    params = TM.init(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert TM.init_cache(cfg, 1, 8, device="cpu")[0]["k"].shape == (1, 8, 2, 32)
