"""The port's kernels (repro_torch.kernels) against the reference.

On the CPU a kernel wrapper computes its plain PyTorch version; it is held
against the reference's oracles (``repro.kernels.ref``) and its Pallas
kernels in interpret mode, on the same inputs made with numpy from a seed.
tests/test_torch_gpu.py holds each CUDA kernel against its plain version on
the card.  K1 takes Sq queries over Sk keys, Sq != Sk included, as the
Pallas kernel does.

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


# Sq != Sk, as the Pallas kernel takes it (whisper's cross-attention
# prefill): (sq, sk, causal, window, dtype), GQA group 2 at hd 64.  Causal
# positions count from 0 on both sides; at Sq 60 over Sk 20 with a window of
# 8 the rows from 27 on see no key, and the reference weighs every key alike.
SQ_SK_CASES = [(sq, sk, causal, None, dtype)
               for sq, sk in ((20, 45), (45, 20), (1, 33), (33, 1))
               for causal in (True, False) for dtype in ("float32", "bfloat16")]
SQ_SK_CASES += [(60, 20, True, 8, "float32"), (20, 60, True, 8, "bfloat16"),
                (60, 20, True, 8, "bfloat16")]


def _sq_sk_inputs(seed, b, sq, sk, h, kv, hd, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))]
    return [_pair(a, dtype) for a in arrs]


@pytest.mark.parametrize("sq,sk,causal,window,dtype", SQ_SK_CASES)
def test_flash_plain_sq_ne_sk_matches_reference_oracle(sq, sk, causal, window, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _sq_sk_inputs(8, 2, sq, sk, 4, 2, 64, dtype)
    want = jref.flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("sq,sk", [(128, 256), (256, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_sq_ne_sk_matches_pallas_interpret(sq, sk, causal, dtype):
    """The Pallas kernel's own sizes (multiples of its 128-row blocks): 4
    query heads over 2 KV heads, hd 64."""
    (qj, qt), (kj, kt), (vj, vt) = _sq_sk_inputs(9, 1, sq, sk, 4, 2, 64, dtype)
    want = jops.flash_attention(qj, kj, vj, causal=causal, interpret=True)
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


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


# --- the split-cache plan of the decode kernel (csrc/decode_attention.cu) ---
@pytest.mark.parametrize("b,kv,L", [
    (4, 32, 264), (4, 8, 16), (4, 8, 520), (1, 8, 4096), (1, 32, 4096),
    (1, 1, 1), (1, 1, 64), (1, 1, 65), (2, 4, 130), (64, 32, 264), (3, 7, 1000),
    (1, 1, 32768)])
def test_split_plan_covers_every_slot_once(b, kv, L):
    splits, chunk = tdec.split_plan(b, kv, L)
    assert chunk % tdec.SPLIT_SLOTS == 0 and splits >= 1
    covered = np.zeros(L, np.int64)
    for s in range(splits):
        assert s * chunk < L, "every split starts inside the cache"
        covered[s * chunk:(s + 1) * chunk] += 1
    assert (covered == 1).all()
    assert splits == 1 or b * kv * splits <= tdec.TARGET_BLOCKS


def test_split_plan_at_the_serving_shapes():
    assert tdec.split_plan(4, 32, 264) == (1, 320)   # phi-3 decode: 128 blocks, no split
    assert tdec.split_plan(4, 8, 16)[0] == 1         # yi-34b decode: one split
    assert tdec.split_plan(4, 8, 520) == (3, 192)    # a longer yi-34b cache: 96 blocks
    assert tdec.split_plan(1, 8, 4096) == (16, 256)  # one sequence: 128 blocks


def _split_combine(q, k, v, lengths, chunk):
    """The kernel's arithmetic at the granularity of its splits, in plain
    PyTorch: split s reads slots [s chunk, (s + 1) chunk) below n =
    min(lengths[b], L) (n = L when lengths[b] <= 0, every slot then scoring
    -1e30) and forms (m, l, acc) with p rounded to V's dtype against its own
    max; a split that starts at or past n has m = -inf, l = 0 and no acc;
    the combine weighs split s by exp(m_s - max m), skips the empty ones,
    and divides by l (1 where l == 0)."""
    b, h, hd = q.shape
    L, kv = k.shape[1], k.shape[2]
    group, scale = h // kv, 1.0 / hd ** 0.5
    out = torch.empty((b, h, hd))
    for bi in range(b):
        ln = int(lengths[bi])
        n = min(ln, L) if ln > 0 else L
        for hi in range(h):
            parts = []
            for s0 in range(0, L, chunk):
                s1 = min(s0 + chunk, n)
                if s1 <= s0:
                    parts.append((-np.inf, 0.0, None))
                    continue
                kk, vv = k[bi, s0:s1, hi // group], v[bi, s0:s1, hi // group]
                sc = (kk.float() @ q[bi, hi].float()) * scale
                if ln <= 0:
                    sc = torch.full_like(sc, -1e30)
                m = sc.max()
                p = torch.exp(sc - m)
                parts.append((float(m), p.sum(), p.to(v.dtype).float() @ vv.float()))
            mx = max(m for m, _, _ in parts)
            den, acc = 0.0, torch.zeros(hd)
            for m, l, a in parts:
                if m == -np.inf:
                    continue
                w = np.exp(m - mx)
                den, acc = den + w * l, acc + w * a
            out[bi, hi] = acc / (den if den != 0 else 1.0)
    return out.to(q.dtype)


# (L, chunk, h, kv, hd): the wrapper's own plan at L 136 (splits at 64 and
# 128), and 8-slot splits at L 24 (at 8 and 16); GQA groups 1 and 7
SPLIT_CASES = [(136, None, 2, 2, 32), (136, None, 7, 1, 64),
               (24, 8, 2, 2, 96), (24, 8, 7, 1, 32)]


@pytest.fixture
def split_case(request):
    (L, chunk, h, kv, hd), dtype = request.param
    chunk = chunk or tdec.split_plan(7, kv, L)[1]
    # lengths 0, 1, a split edge -1, +0, +1, L and beyond L
    lengths = [0, 1, chunk - 1, chunk, chunk + 1, L, L + 50]
    pairs = _decode_inputs(8, len(lengths), L, h, kv, hd, dtype, lengths)
    return pairs, chunk, dtype


SPLIT_PARAMS = [(c, d) for c in SPLIT_CASES for d in ("float32", "bfloat16")]


@pytest.mark.parametrize("split_case", SPLIT_PARAMS, indirect=True)
def test_split_combine_matches_reference_oracle(split_case):
    pairs, chunk, dtype = split_case
    (qj, qt), (kj, kt), (vj, vt), (lj, lt) = pairs
    got = _split_combine(qt, kt, vt, lt, chunk)
    want = jref.decode_attention_ref(qj, kj, vj, lj)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("split_case", SPLIT_PARAMS, indirect=True)
def test_split_combine_matches_pallas_interpret(split_case):
    pairs, chunk, dtype = split_case
    (qj, qt), (kj, kt), (vj, vt), (lj, lt) = pairs
    got = _split_combine(qt, kt, vt, lt, chunk)
    want = jops.decode_attention(qj, kj, vj, lj, block_k=8, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_split_combine_weighs_empty_splits_zero_and_masked_rows_alike():
    """lengths 1 leaves every split but the first empty (m = -inf): the
    output is V's first slot.  lengths 0 scores every slot -1e30 in every
    split: the output is the mean of V, not NaN."""
    (_, qt), (_, kt), (_, vt), (_, lt) = _decode_inputs(9, 2, 200, 2, 2, 32, "float32",
                                                        [1, 0])
    got = _split_combine(qt, kt, vt, lt, 64)
    np.testing.assert_allclose(_np(got[0]), _np(vt[0, 0]), atol=1e-6)
    np.testing.assert_allclose(_np(got[1]), _np(vt[1].mean(dim=0)), atol=1e-6)


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
                                 "window", "batch", "no_keys", "no_queries"])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(bad):
    b, s, h, kv, hd = 1, 8, 4, 2, 32
    if bad == "head_dim":
        hd = 48
    if bad == "group":
        kv = 3
    q = torch.zeros((b, 0 if bad == "no_queries" else s, h, hd))
    sk = 0 if bad == "no_keys" else s + 3
    k = torch.zeros((b + (bad == "batch"), sk, kv, hd))
    v = torch.zeros((b + (bad == "batch"), sk, kv, hd))
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


# --- the rounding plan of the bf16 SSD kernel (csrc/ssd_scan.cu) -----------
def _split3(t):
    """An f32 operand as the kernel feeds it to bf16 tensor-core products:
    hi = bf16(t), mid = bf16(t - hi), lo = bf16(t - hi - mid), the three
    products summed in f32."""
    hi = t.to(torch.bfloat16).float()
    mid = (t - hi).to(torch.bfloat16).float()
    return hi + mid + (t - hi - mid).to(torch.bfloat16).float()


def _hi_lo(t):
    """Two bf16 terms: hi = bf16(t), lo = bf16(t - hi)."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def _bf16_once(t):
    return t.to(torch.bfloat16).float()


def _f32(t):
    return t


def _ssd_kernel_roundings(x, dt, a_neg, bm, cm, chunk, w=_split3, scaled_b=_split3,
                          state=_split3):
    """The bf16 kernel's passes in the plain algebra, with its operand
    roundings: the bf16 inputs x, B, C enter exactly; the decayed scores
    W = CB * exp(seg(j, i)) * dt_j, the scaled B of the chunk states and the
    carried state pass through ``w``, ``scaled_b`` and ``state``.  One group,
    S a multiple of ``chunk``."""
    b, s, h, p = x.shape
    nc = s // chunk
    xf = x.float().reshape(b, nc, chunk, h, p)
    bf = bm.float().reshape(b, nc, chunk, bm.shape[-1])             # G = 1
    cf = cm.float().reshape(b, nc, chunk, cm.shape[-1])
    dtc = dt.reshape(b, nc, chunk, h).movedim(-1, 2)                # (b, nc, h, l)
    seg = tssd.segsum(dtc * a_neg[None, None, :, None])             # (b, nc, h, l, l)
    decay = torch.exp(seg)
    cb = torch.einsum("bcin,bcjn->bcij", cf, bf)[:, :, None]       # once per group
    wts = w(cb * decay * dtc[..., None, :])
    y = torch.einsum("bchij,bcjhp->bcihp", wts, xf)
    bs = scaled_b(bf[:, :, None] * (dtc * decay[..., -1, :])[..., None])   # (b, nc, h, l, n)
    ds = torch.einsum("bcjhp,bchjn->bchpn", xf, bs)
    cum = torch.exp(torch.cumsum(dtc * a_neg[None, None, :, None], dim=-1))
    s_in = torch.zeros_like(ds[:, 0])
    for c in range(nc):
        y[:, c] += torch.einsum("bin,bhpn->bihp", cf[:, c], state(s_in)) \
            * cum[:, c].movedim(-1, 1)[..., None]
        s_in = s_in * cum[:, c, :, -1, None, None] + ds[:, c]
    return y.reshape(b, s, h, p).to(x.dtype), s_in


def _rounding_plan_inputs():
    """chip_smoke.py's SSD inputs at a reduced size: x, B, C standard normal
    in bf16, dt = softplus(normal), a_neg = -linspace(1, 16, H)."""
    b, s, h, p, n = 1, 512, 16, 64, 128
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32))
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((b, s, h)).astype(np.float32)))
    bm = torch.from_numpy(rng.standard_normal((b, s, 1, n)).astype(np.float32))
    cm = torch.from_numpy(rng.standard_normal((b, s, 1, n)).astype(np.float32))
    return (x.bfloat16(), dt, -torch.linspace(1.0, 16.0, h), bm.bfloat16(), cm.bfloat16())


def test_ssd_kernel_rounding_plan_holds_the_tolerances():
    """Three bf16 terms for every f32 operand keep the bf16 kernel within
    chip_smoke.py's tolerances of the plain version: y 2e-2, the f32 state
    atol 5e-4 / rtol 5e-3."""
    args = _rounding_plan_inputs()
    y_want, f_want = tssd.ssd_scan_plain(*args, 256)
    y, f = _ssd_kernel_roundings(*args, 256)
    np.testing.assert_allclose(_np(y), _np(y_want), **SSD_TOL["bfloat16"])
    np.testing.assert_allclose(_np(f), _np(f_want), **SSD_TOL["float32"])


def test_ssd_rounding_the_scores_once_misses_the_y_tolerance():
    """The same passes with W rounded to bf16 once: y leaves its 2e-2
    tolerance, so a plan that drops the lower terms cannot pass unseen."""
    args = _rounding_plan_inputs()
    y_want, _ = tssd.ssd_scan_plain(*args, 256)
    y, _ = _ssd_kernel_roundings(*args, 256, w=_bf16_once)
    assert not np.allclose(_np(y), _np(y_want), **SSD_TOL["bfloat16"])


def test_ssd_three_terms_round_y_like_f32_operands():
    """y's bf16 rounding differs from the plain version's (one ulp) about as
    rarely with three bf16 terms as with exact f32 operands; with two terms
    (hi + lo, which still holds the tolerances) at least ten times as often,
    enough to change greedy tokens of a 64-layer bf16 model."""
    args = _rounding_plan_inputs()
    y_want, _ = tssd.ssd_scan_plain(*args, 256)
    flips = {name: int((_ssd_kernel_roundings(*args, 256, w=fn, scaled_b=fn, state=fn)[0]
                        != y_want).sum())
             for name, fn in (("f32", _f32), ("three", _split3), ("two", _hi_lo))}
    assert flips["three"] <= 2 * flips["f32"] + 2, flips
    assert flips["two"] >= 10 * max(flips["f32"], 1), flips
