"""repro_torch.models.layers against repro.models.layers, function by
function, on the same parameters: numpy arrays from a seed, in the
reference's layouts, handed to both.

Tolerances are the reference's: 2e-4 for f32, 2e-2 for bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

F32 = dict(atol=2e-4, rtol=2e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _dense(seed, *shape):
    """A weight with the reference's init scale, 1 / sqrt(fan_in)."""
    return _randn(seed, *shape) / np.float32(np.sqrt(shape[0]))


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_rms_norm(dtype, tol):
    x, scale = _randn(0, 2, 5, 64), 0.1 * _randn(1, 64)
    want = JL.rms_norm(jnp.asarray(x, dtype), jnp.asarray(scale, dtype), 1e-6)
    tdt = getattr(torch, dtype)
    got = TL.rms_norm(_t(x, tdt), _t(scale, tdt), 1e-6)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("hd,theta", [(32, 5_000_000.0), (96, 10_000.0)])
def test_apply_rope(hd, theta):
    x = _randn(2, 2, 7, 3, hd)
    pos = np.broadcast_to(np.arange(300, 307)[None], (2, 7)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(_t(x), torch.from_numpy(pos.copy()), theta)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("gated", [True, False], ids=["swiglu", "gelu_tanh"])
def test_mlp(gated):
    p = {"w_in": _dense(0, 64, 256), "w_out": _dense(1, 256, 64)}
    if gated:
        p["w_gate"] = _dense(2, 64, 256)
    x = _randn(3, 2, 5, 64)
    want = JL.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = TL.mlp({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; the exact form
    differs from it by more than the f32 tolerance."""
    x = np.linspace(-3, 3, 601, dtype=np.float32)
    want = _np(jax.nn.gelu(jnp.asarray(x)))
    tanh = TL.F.gelu(_t(x), approximate="tanh")
    exact = TL.F.gelu(_t(x))
    np.testing.assert_allclose(_np(tanh), want, atol=1e-6)
    assert np.abs(_np(exact) - want).max() > 2e-4


def _attn_inputs(seed, b, s, h, kv, hd):
    return (_randn(seed, b, s, h, hd), _randn(seed + 1, b, s, kv, hd),
            _randn(seed + 2, b, s, kv, hd))


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_attention(window, impl):
    q, k, v = _attn_inputs(4, 2, 12, 6, 2, 32)
    pos = np.broadcast_to(np.arange(12)[None], (2, 12)).astype(np.int32)
    want = JL.attention_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos), jnp.asarray(pos), window)
    tpos = torch.from_numpy(pos.copy())
    got = TL.attention(_t(q), _t(k), _t(v), tpos, tpos, window=window, impl=impl)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_attention_decode():
    q = _randn(7, 3, 1, 4, 64)
    kc, vc = _randn(8, 3, 10, 2, 64), _randn(9, 3, 10, 2, 64)
    clen = np.array([0, 4, 25], np.int32)
    want = JL.attention_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                               jnp.asarray(clen))
    got = TL.attention_decode(_t(q), _t(kc), _t(vc), torch.from_numpy(clen))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.fixture
def attn_block_case(request):
    """Weights, input, positions and the reference's output and (k, v)."""
    dtype, window = request.param
    jd = getattr(jnp, dtype)
    p = {"wq": _dense(11, 64, 4, 32), "wk": _dense(12, 64, 2, 32),
         "wv": _dense(13, 64, 2, 32), "wo": _dense(14, 4, 32, 64)}
    x = _randn(10, 2, 9, 64)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9)).astype(np.int32)
    jp = {k: jnp.asarray(v, jd) for k, v in p.items()}
    want, (wk, wv) = JL.attn_block(jp, jnp.asarray(x, jd), jnp.asarray(pos),
                                   10_000.0, window=window, impl="naive")
    return dtype, window, p, x, pos, [_np(w) for w in (want, wk, wv)]


@pytest.mark.parametrize("attn_block_case", [
    ("float32", None), ("float32", 4), ("bfloat16", None)], indirect=True)
def test_attn_block(attn_block_case):
    dtype, window, p, x, pos, wants = attn_block_case
    td = getattr(torch, dtype)
    tp = {k: _t(v, td) for k, v in p.items()}
    got, (gk, gv) = TL.attn_block(tp, _t(x, td), torch.from_numpy(pos.copy()),
                                  10_000.0, window=window, impl="kernel")
    for g, w in zip((got, gk, gv), wants):
        np.testing.assert_allclose(_np(g), w, **(BF16 if dtype == "bfloat16" else F32))
