"""The port stands alone: it imports no JAX and nothing of the reference
package, keeps its kernels on the path, and its entry points do not fall
back to the CPU when no device is given."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.serving.engine import StageServer

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
# exactly the modules jax and repro, not repro_torch
FOREIGN_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


@pytest.fixture(scope="module")
def blocked_import():
    """A fresh interpreter that imports the port with jax and repro blocked."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "import repro_torch, repro_torch.kernels, repro_torch.models, "
            "repro_torch.models.moe, repro_torch.serving, repro_torch.core, "
            "repro_torch.launch.serve\n"
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


def test_no_library_attention_or_compile_on_the_port_path():
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        for banned in ("scaled_dot_product_attention", "torch.compile"):
            assert banned not in text, (path, banned)


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


def test_cpu_is_explicit(no_cuda):
    cfg = TC.get_config("yi-34b", reduced=True)
    params = TM.init(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert TM.init_cache(cfg, 1, 8, device="cpu")[0]["k"].shape == (1, 8, 2, 32)
