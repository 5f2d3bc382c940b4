"""The port on the card: each CUDA kernel against its plain PyTorch version,
and the model and engine paths through the kernels against the naive path.

Every test is marked ``gpu`` and skips inside the test where there is no
CUDA device.  The file imports neither jax nor the reference package, so it
runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerances are the reference's: 2e-4 for f32, 2e-2 for bf16.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import decode_attention as K2
from repro_torch.kernels import flash_attention as K1
from repro_torch.models import model as M
from repro_torch.serving.engine import StageServer

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(atol=2e-4, rtol=2e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _randn(seed, shape, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to("cuda", dtype)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **TOL[dtype])


# (b, s, h, kv, hd, window, causal, dtype): ragged S, GQA group 7, hd 32..128
FLASH = [
    (2, 20, 4, 2, 32, None, True, torch.float32),
    (1, 16, 7, 1, 64, None, True, torch.float32),
    (1, 130, 2, 2, 96, 8, True, torch.float32),
    (2, 64, 4, 2, 128, None, False, torch.float32),
    (1, 33, 14, 2, 128, None, True, torch.bfloat16),
    (2, 200, 4, 4, 96, 70, True, torch.bfloat16),
    (1, 65, 8, 2, 64, 1, True, torch.bfloat16),
    (4, 512, 56, 8, 128, None, True, torch.bfloat16),
    (4, 500, 32, 32, 96, 64, True, torch.bfloat16),
]


@pytest.mark.parametrize("b,s,h,kv,hd,window,causal,dtype", FLASH)
def test_flash_kernel_matches_plain(b, s, h, kv, hd, window, causal, dtype):
    _need_cuda()
    q = _randn(0, (b, s, h, hd), dtype)
    k, v = _randn(1, (b, s, kv, hd), dtype), _randn(2, (b, s, kv, hd), dtype)
    n = K1.flash_attention.launches
    got = K1.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert K1.flash_attention.launches == n + 1
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, K1.flash_attention_plain(q, k, v, causal=causal, window=window), dtype)


# (b, L, h, kv, hd, lengths, dtype): ragged L; lengths 0, L and past L
DECODE = [
    (3, 20, 8, 2, 32, [0, 20, 7], torch.float32),
    (2, 20, 7, 1, 96, [1, 13], torch.float32),
    (3, 130, 4, 4, 64, [129, 300, 64], torch.float32),
    (2, 33, 14, 2, 128, [33, 0], torch.bfloat16),
    (4, 520, 56, 8, 128, [0, 520, 17, 300], torch.bfloat16),
    (4, 520, 32, 32, 96, [1, 64, 65, 519], torch.float32),
]


@pytest.mark.parametrize("b,L,h,kv,hd,lengths,dtype", DECODE)
def test_decode_kernel_matches_plain(b, L, h, kv, hd, lengths, dtype):
    _need_cuda()
    q = _randn(3, (b, h, hd), dtype)
    k, v = _randn(4, (b, L, kv, hd), dtype), _randn(5, (b, L, kv, hd), dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    n = K2.decode_attention.launches
    got = K2.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert K2.decode_attention.launches == n + 1
    _close(got, K2.decode_attention_plain(q, k, v, lens), dtype)


def test_wrappers_refuse_before_launching():
    _need_cuda()
    q = torch.zeros((1, 8, 4, 48), device="cuda")
    n = K1.flash_attention.launches
    with pytest.raises(ValueError):
        K1.flash_attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    assert K1.flash_attention.launches == n


@pytest.mark.parametrize("arch,d_model", [("yi-34b", 256), ("phi-3-vision-4.2b", 384),
                                          ("starcoder2-3b", 128), ("gemma3-27b", 128)])
def test_model_kernel_path_matches_naive_path(arch, d_model):
    """Prefill past the window and decode across it, f32."""
    _need_cuda()
    cfg = configs.arch_module(arch).reduced(2, d_model)
    params = M.init(cfg, seed=0)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 74))).cuda()
    out = {}
    with torch.inference_mode():
        for impl in ("kernel", "naive"):
            hl, caches, s = M.prefill(params, cfg, {"tokens": toks[:, :66]}, impl=impl,
                                      capacity=74)
            lgs = [hl @ params["embed"].T]
            for t in range(66, 74):
                lg, caches = M.decode_step(params, cfg, caches, t, toks[:, t:t + 1], impl=impl)
                lgs.append(lg)
            out[impl] = torch.stack(lgs)
    _close(out["kernel"], out["naive"], torch.float32)


def test_engine_runs_the_kernels():
    _need_cuda()
    fam = configs.get_variant_family("yi-34b")[:1]
    srv = StageServer("yi-34b", fam, gen_tokens=3)
    srv.process(np.zeros((2, 16), np.int32))
    n1, n2 = K1.flash_attention.launches, K2.decode_attention.launches
    out, lat = srv.process(np.arange(32, dtype=np.int32).reshape(2, 16))
    layers = fam[0][1].n_layers
    assert K1.flash_attention.launches - n1 == layers
    assert K2.decode_attention.launches - n2 == 3 * layers
    assert out.shape == (2, 3) and lat > 0


def test_full_width_layer_kernel_path_matches_naive_path():
    """One yi-34b layer at full width (56 heads over 8 KV heads, hd 128),
    f32 so that the comparison sees the kernels and not bf16 rounding."""
    _need_cuda()
    cfg = dataclasses.replace(configs.get_config("yi-34b"), n_layers=1,
                              dtype=torch.float32)
    params = M.init(cfg, seed=0)
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (2, 40))).cuda()
    with torch.inference_mode():
        hk = M.forward(params, cfg, {"tokens": toks}, impl="kernel")
        hn = M.forward(params, cfg, {"tokens": toks}, impl="naive")
    _close(hk, hn, torch.float32)
