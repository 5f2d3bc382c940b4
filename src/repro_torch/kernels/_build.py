"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` becomes a shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` (Hopper) and loaded with ``ctypes``.
Libraries go to ``build/repro_torch/`` at the root of the checkout (listed
in ``.gitignore``), in a directory keyed by a hash of the sources and flags,
so an edited source is rebuilt and an unchanged one is reused.  ``build``
starts one ``nvcc`` per source, all at once, and returns each compiler's
``-Xptxas -v`` report (registers, shared memory, spills per kernel).

Nothing here runs at import: the CPU tests import every module, and
``nvcc`` is needed only once a CUDA tensor reaches a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("flash_attention", "decode_attention", "ssd_scan", "moe_experts")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _out_dir(name: str) -> Path:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}"


def _lib_path(name: str) -> Path:
    return _out_dir(name) / f"lib{name}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    per source, all started together.  Returns ``{name: ptxas report}``."""
    procs = {}
    for name in names:
        out = _out_dir(name)
        if (out / f"lib{name}.so").exists():
            continue
        out.mkdir(parents=True, exist_ok=True)
        # compile to a private name and rename, so that processes building
        # the same source at once never load a half-written library
        tmp = out / f"lib{name}.so.{os.getpid()}"
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (_out_dir(name) / "ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: (_out_dir(name) / "ptxas.txt").read_text() for name in names}


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it if needed."""
    if name not in _libs:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def refuse_autograd(what: str, *tensors) -> None:
    """Raise where autograd would record a kernel's call: the kernels have
    no backward, and their outputs, written through ``ctypes``, would carry
    no gradient.  The same on a CPU tensor, whose plain version could
    differentiate, so that both devices behave alike."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: an input requires grad.  Train through "
            "impl='naive' or impl='chunked', or call it under torch.no_grad()")


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} ({msg})")
