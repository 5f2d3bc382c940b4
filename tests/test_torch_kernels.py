"""The port's kernels (repro_torch.kernels) against the reference.

On the CPU a kernel wrapper computes its plain PyTorch version; it is held
against the reference's oracles (``repro.kernels.ref``) and its Pallas
kernels in interpret mode, on the same inputs made with numpy from a seed.
tests/test_torch_gpu.py holds each CUDA kernel against its plain version on
the card.

Tolerances are the reference's own (tests/test_kernels.py): 2e-4 for f32,
2e-2 for bf16, and for the SSD scan atol 5e-4 / rtol 5e-3 in f32 (its
chunked sums add in another order than the recurrence).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as tssd

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
SSD_TOL = {"float32": dict(atol=5e-4, rtol=5e-3),
           "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _pair(a, dtype):
    """One numpy f32 array as a jax and a torch array of ``dtype``; both
    round to bf16 to nearest even, so the two get the same values."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _attn_inputs(seed, b, s, h, kv, hd, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]
    return [_pair(a, dtype) for a in arrs]


def _decode_inputs(seed, b, L, h, kv, hd, dtype, lengths):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, hd), (b, L, kv, hd), (b, L, kv, hd))]
    lens = np.asarray(lengths, np.int32)
    return ([_pair(a, dtype) for a in arrs]
            + [(jnp.asarray(lens), torch.from_numpy(lens))])


# (b, s, h, kv, hd, window, dtype): ragged S, GQA group 7, hd 32..128
FLASH_CASES = [
    (2, 20, 4, 2, 32, None, "float32"),
    (1, 16, 7, 1, 64, None, "float32"),
    (1, 24, 2, 2, 96, 8, "float32"),
    (1, 33, 14, 2, 128, None, "bfloat16"),
    (2, 20, 4, 4, 96, 6, "bfloat16"),
    (1, 19, 8, 2, 64, 1, "float32"),
]


@pytest.fixture
def flash_oracle(request):
    """Port inputs, window, dtype and the reference oracle's output."""
    b, s, h, kv, hd, window, dtype = request.param
    (qj, qt), (kj, kt), (vj, vt) = _attn_inputs(0, b, s, h, kv, hd, dtype)
    want = jref.flash_attention_ref(qj, kj, vj, window=window)
    return (qt, kt, vt), window, dtype, _np(want)


@pytest.mark.parametrize("flash_oracle", FLASH_CASES, indirect=True)
def test_flash_plain_matches_reference_oracle(flash_oracle):
    (qt, kt, vt), window, dtype, want = flash_oracle
    got = ops.flash_attention(qt, kt, vt, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), want, **TOL[dtype])


@pytest.fixture
def flash_pallas(request):
    """Several 16-row blocks, so the Pallas kernel carries its online
    softmax across KV blocks, including wholly masked ones."""
    window, dtype, h, kv, hd = request.param
    (qj, qt), (kj, kt), (vj, vt) = _attn_inputs(1, 1, 48, h, kv, hd, dtype)
    want = jops.flash_attention(qj, kj, vj, window=window, block_q=16,
                                block_k=16, interpret=True)
    return (qt, kt, vt), window, dtype, _np(want)


@pytest.mark.parametrize("flash_pallas", [
    (None, "float32", 7, 1, 64),
    (8, "float32", 4, 2, 32),
    (None, "bfloat16", 4, 4, 96),
], indirect=True)
def test_flash_plain_matches_pallas_interpret(flash_pallas):
    (qt, kt, vt), window, dtype, want = flash_pallas
    got = ref.flash_attention_ref(qt, kt, vt, window=window)
    np.testing.assert_allclose(_np(got), want, **TOL[dtype])


@pytest.fixture
def non_causal():
    (qj, qt), (kj, kt), (vj, vt) = _attn_inputs(2, 2, 12, 4, 2, 32, "float32")
    return (qt, kt, vt), _np(jref.flash_attention_ref(qj, kj, vj, causal=False))


def test_flash_plain_non_causal_matches_oracle(non_causal):
    (qt, kt, vt), want = non_causal
    got = ops.flash_attention(qt, kt, vt, causal=False)
    np.testing.assert_allclose(_np(got), want, **TOL["float32"])


# (b, L, h, kv, hd, lengths, dtype): ragged L, lengths 0 and L, group 7
DECODE_CASES = [
    (3, 20, 8, 2, 32, [0, 20, 7], "float32"),
    (2, 20, 7, 1, 96, [1, 13], "float32"),
    (2, 33, 14, 2, 128, [33, 0], "bfloat16"),
    (3, 9, 4, 4, 64, [9, 30, 4], "bfloat16"),
]


@pytest.fixture
def decode_oracle(request):
    b, L, h, kv, hd, lengths, dtype = request.param
    (qj, qt), (kj, kt), (vj, vt), (lj, lt) = _decode_inputs(
        3, b, L, h, kv, hd, dtype, lengths)
    want = jref.decode_attention_ref(qj, kj, vj, lj)
    return (qt, kt, vt, lt), dtype, _np(want)


@pytest.mark.parametrize("decode_oracle", DECODE_CASES, indirect=True)
def test_decode_plain_matches_reference_oracle(decode_oracle):
    (qt, kt, vt, lt), dtype, want = decode_oracle
    got = ops.decode_attention(qt, kt, vt, lt)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), want, **TOL[dtype])


@pytest.fixture
def decode_pallas(request):
    dtype = request.param
    (qj, qt), (kj, kt), (vj, vt), (lj, lt) = _decode_inputs(
        4, 3, 24, 7, 1, 64, dtype, [0, 24, 5])
    want = jops.decode_attention(qj, kj, vj, lj, block_k=8, interpret=True)
    return (qt, kt, vt, lt), dtype, _np(want)


@pytest.mark.parametrize("decode_pallas", ["float32", "bfloat16"], indirect=True)
def test_decode_plain_matches_pallas_interpret(decode_pallas):
    (qt, kt, vt, lt), dtype, want = decode_pallas
    got = ref.decode_attention_ref(qt, kt, vt, lt)
    np.testing.assert_allclose(_np(got), want, **TOL[dtype])


def test_decode_length_zero_is_mean_of_values():
    (_, qt), (_, kt), (_, vt), (_, lt) = _decode_inputs(
        5, 1, 10, 4, 2, 32, "float32", [0])
    got = ops.decode_attention(qt, kt, vt, lt)
    want = vt.mean(dim=1).repeat_interleave(2, dim=1)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6)


def test_decode_ignores_slots_past_length():
    (_, qt), (_, kt), (_, vt), (_, lt) = _decode_inputs(
        6, 1, 16, 4, 2, 32, "float32", [9])
    out1 = ops.decode_attention(qt, kt, vt, lt)
    kt[:, 9:] = 999.0
    vt[:, 9:] = -999.0
    out2 = ops.decode_attention(qt, kt, vt, lt)
    np.testing.assert_allclose(_np(out1), _np(out2), atol=1e-6)


def test_cpu_tensors_launch_no_kernel():
    (_, qt), (_, kt), (_, vt) = _attn_inputs(7, 1, 8, 2, 2, 32, "float32")
    before = (tfa.flash_attention.launches, tdec.decode_attention.launches,
              tssd.ssd_scan.launches)
    ops.flash_attention(qt, kt, vt)
    ops.decode_attention(qt[:, 0], kt, vt, torch.tensor([8], dtype=torch.int32))
    ops.ssd_scan(*[t for _, t in _ssd_inputs(7, 1, 20, 2, 16, 1, 8, "float32")], chunk=16)
    assert (tfa.flash_attention.launches, tdec.decode_attention.launches,
            tssd.ssd_scan.launches) == before


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "contiguity", "group",
                                 "window"])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(bad):
    b, s, h, kv, hd = 1, 8, 4, 2, 32
    if bad == "head_dim":
        hd = 48
    if bad == "group":
        kv = 3
    q = torch.zeros((b, s, h, hd))
    k = torch.zeros((b, s, kv, hd))
    v = torch.zeros((b, s, kv, hd))
    window = None
    if bad == "dtype":
        v = v.to(torch.bfloat16)
    if bad == "contiguity":
        q = torch.zeros((b, h, s, hd)).transpose(1, 2)
    if bad == "window":
        window = 0
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, window=window)


@pytest.mark.parametrize("bad", ["lengths_dtype", "lengths_shape", "head_dim"])
def test_decode_wrapper_rejects_what_the_kernel_does_not_take(bad):
    b, L, h, kv, hd = 2, 8, 4, 2, 32
    if bad == "head_dim":
        hd = 80
    q = torch.zeros((b, h, hd))
    kc = torch.zeros((b, L, kv, hd))
    lengths = torch.full((b,), 3, dtype=torch.int32)
    if bad == "lengths_dtype":
        lengths = lengths.long()
    if bad == "lengths_shape":
        lengths = lengths[:1]
    with pytest.raises(ValueError):
        ops.decode_attention(q, kc, kc.clone(), lengths)


def _ssd_inputs(seed, b, s, h, p, g, n, dtype):
    """x, dt (softplus'ed), a_neg, B, C as (jax, torch) pairs; x, B, C in
    ``dtype``, dt and a_neg in f32, as the Mamba layer hands them over."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0.0).astype(np.float32)
    a_neg = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return [_pair(x, dtype), _pair(dt, "float32"), _pair(a_neg, "float32"),
            _pair(bm, dtype), _pair(cm, dtype)]


# the sweep of tests/test_kernels.py (b, s, h, p, g, n, chunk), and bf16
SSD_SWEEP = [
    (2, 128, 4, 16, 2, 8, 32, "float32"),
    (1, 64, 2, 32, 1, 16, 16, "float32"),
    (2, 96, 4, 16, 4, 8, 32, "float32"),
    (1, 64, 4, 32, 2, 16, 32, "bfloat16"),
]


@pytest.fixture
def ssd_case(request):
    b, s, h, p, g, n, chunk, dtype = request.param
    pairs = _ssd_inputs(4, b, s, h, p, g, n, dtype)
    return [j for j, _ in pairs], [t for _, t in pairs], chunk, dtype


@pytest.mark.parametrize("ssd_case", SSD_SWEEP, indirect=True)
def test_ssd_plain_matches_pallas_interpret(ssd_case):
    jargs, targs, chunk, dtype = ssd_case
    y_want, f_want = jops.ssd_scan(*jargs, chunk=chunk, interpret=True)
    y, f = ops.ssd_scan(*targs, chunk=chunk)
    assert y.dtype == targs[0].dtype and f.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(y_want), **SSD_TOL[dtype])
    np.testing.assert_allclose(_np(f), _np(f_want), **SSD_TOL["float32"])


@pytest.mark.parametrize("ssd_case", SSD_SWEEP, indirect=True)
def test_ssd_plain_matches_reference_recurrence(ssd_case):
    """Both packages' O(S) recurrence oracles, and the port's scan against
    the reference's oracle."""
    jargs, targs, chunk, dtype = ssd_case
    y_want, f_want = jref.ssd_scan_ref(*jargs)
    y_ref, f_ref = ref.ssd_scan_ref(*targs)
    np.testing.assert_allclose(_np(y_ref), _np(y_want), **SSD_TOL["float32"])
    np.testing.assert_allclose(_np(f_ref), _np(f_want), **SSD_TOL["float32"])
    y, f = ops.ssd_scan(*targs, chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(y_want), **SSD_TOL[dtype])
    np.testing.assert_allclose(_np(f), _np(f_want), **SSD_TOL["float32"])


def test_ssd_continuation_matches_pallas_interpret():
    """The reference's split (tests/test_kernels.py) on both packages: the
    second half starts from the first half's final state."""
    pairs = _ssd_inputs(5, 1, 128, 2, 16, 1, 8, "float32")
    jargs, targs = [j for j, _ in pairs], [t for _, t in pairs]
    m = 64
    half = lambda args, sl: [a if a.ndim == 1 else a[:, sl] for a in args]  # noqa: E731
    _, jf1 = jops.ssd_scan(*half(jargs, slice(0, m)), chunk=32, interpret=True)
    jy2, jf2 = jops.ssd_scan(*half(jargs, slice(m, None)), chunk=32, init_state=jf1,
                             interpret=True)
    _, f1 = ops.ssd_scan(*[t.contiguous() for t in half(targs, slice(0, m))], chunk=32)
    y2, f2 = ops.ssd_scan(*[t.contiguous() for t in half(targs, slice(m, None))], chunk=32,
                          init_state=f1)
    np.testing.assert_allclose(_np(f1), _np(jf1), **SSD_TOL["float32"])
    np.testing.assert_allclose(_np(y2), _np(jy2), **SSD_TOL["float32"])
    np.testing.assert_allclose(_np(f2), _np(jf2), **SSD_TOL["float32"])


@pytest.mark.parametrize("bad", ["head_dim", "d_state", "chunk", "dtype", "dt_dtype",
                                 "contiguity", "groups", "init_state"])
def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(bad):
    b, s, h, p, g, n, chunk = 1, 8, 4, 16, 2, 8, 16
    if bad == "head_dim":
        p = 48
    if bad == "d_state":
        n = 12
    if bad == "chunk":
        chunk = 48
    if bad == "groups":
        g = 3
    x = torch.zeros((b, s, h, p))
    dt = torch.zeros((b, s, h))
    a_neg = -torch.ones(h)
    bm, cm = torch.zeros((b, s, g, n)), torch.zeros((b, s, g, n))
    init = None
    if bad == "dtype":
        bm = bm.to(torch.bfloat16)
    if bad == "dt_dtype":
        dt = dt.to(torch.bfloat16)
    if bad == "contiguity":
        x = torch.zeros((b, h, s, p)).transpose(1, 2)
    if bad == "init_state":
        init = torch.zeros((b, h, p, n), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, a_neg, bm, cm, chunk=chunk, init_state=init)
