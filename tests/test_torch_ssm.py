"""repro_torch.models.ssm (Mamba2) against repro.models.ssm, and the Mamba2
family through the port's model and engine against the reference's.

Inputs are numpy arrays from a seed, handed to both packages; parameters
are the reference's own (``init_mamba`` / ``model.init``), converted through
numpy.  The port runs ``impl="kernel"``, which on the CPU is the SSD
kernel's plain version.  Tolerances are the reference's: 2e-4 for f32 and
2e-2 for bf16 at the layer, and the SSD scan's atol 5e-4 / rtol 5e-3 where
a chunked scan meets the O(S) recurrence (tests/test_kernels.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import model as JM
from repro.models import ssm as JS
from repro.serving import engine as JE
from repro_torch import configs as TC
from repro_torch.configs.base import SSMConfig as TSSMConfig
from repro_torch.core.pipeline import StageModel
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.serving import engine as TE

F32 = dict(atol=2e-4, rtol=2e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
SSD = dict(atol=5e-4, rtol=5e-3)
D_MODEL = 64
SCFG = dict(d_state=16, head_dim=32, expand=2, d_conv=4, chunk_size=32)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ssd_chunked_ref = jax.jit(JS.ssd_chunked, static_argnums=5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _torch_like(a):
    """A reference leaf as a torch tensor of the same dtype."""
    a = np.asarray(a)
    dtype = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
    return torch.from_numpy(a.astype(np.float32)).to(dtype)


def _ssd_inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    arrs = (_randn(rng, b, s, h, p), np.logaddexp(_randn(rng, b, s, h), 0).astype(np.float32),
            -np.exp(_randn(rng, h)), _randn(rng, b, s, g, n), _randn(rng, b, s, g, n))
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,chunk,g", [(50, 32, 2), (10, 32, 1), (64, 16, 4), (33, 256, 1)])
def test_ragged_and_short_sequences_match_ssd_chunked(s, chunk, g):
    """The port does not cap the chunk at S; the reference's jnp path pads
    to a multiple of it.  Both scans and the port's kernel wrapper agree."""
    jargs, targs = _ssd_inputs(1, 2, s, 4, 16, g, 8)
    y_want, f_want = ssd_chunked_ref(*jargs, chunk)
    for y, f in (TS.ssd_chunked(*targs, chunk),
                 TS.ops.ssd_scan(*targs, chunk=chunk)):
        assert y.shape == (2, s, 4, 16)
        np.testing.assert_allclose(_np(y), _np(y_want), **F32)
        np.testing.assert_allclose(_np(f), _np(f_want), **F32)


@pytest.mark.parametrize("impl", ["kernel", "naive"])
def test_init_state_continuation(impl):
    """Three pieces, each starting from the state the last one ended in,
    against one pass of the reference."""
    jargs, targs = _ssd_inputs(2, 1, 100, 4, 16, 2, 8)
    y_want, f_want = ssd_chunked_ref(*jargs, 32)
    ys, state = [], None
    for lo, hi in ((0, 37), (37, 64), (64, 100)):
        piece = [t if t.dim() == 1 else t[:, lo:hi].contiguous() for t in targs]
        if impl == "kernel":
            y, state = TS.ops.ssd_scan(*piece, chunk=32, init_state=state)
        else:
            y, state = TS.ssd_chunked(*piece, 32, init_state=state)
        ys.append(y)
    np.testing.assert_allclose(_np(torch.cat(ys, dim=1)), _np(y_want), **SSD)
    np.testing.assert_allclose(_np(state), _np(f_want), **SSD)


def test_ssd_reference_matches_with_init_state():
    jargs, targs = _ssd_inputs(3, 2, 20, 4, 16, 2, 8)
    s0 = _randn(np.random.default_rng(4), 2, 4, 16, 8)
    y_want, f_want = JS.ssd_reference(*jargs, init_state=jnp.asarray(s0))
    y, f = TS.ssd_reference(*targs, init_state=torch.from_numpy(s0))
    np.testing.assert_allclose(_np(y), _np(y_want), **F32)
    np.testing.assert_allclose(_np(f), _np(f_want), **F32)


def test_segsum_matches_reference():
    a = -np.abs(_randn(np.random.default_rng(5), 3, 12))
    want = np.asarray(JS._segsum(jnp.asarray(a)))
    got = TS._segsum(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_direct_segment_sums_hold_digits_at_large_decay(seed):
    """Heads with decay rates 16 and 12 over a 256-row chunk take the
    prefix sums to about -2900.  The port sums each decay exponent over its
    own segment and stays within 5e-5 of an f64 recurrence; the reference's
    differences of prefix sums lose several times more (ROADMAP queue 3,
    P4)."""
    rng = np.random.default_rng(seed)
    b, s, h, p, g, n = 1, 256, 2, 16, 1, 32
    x, dt = _randn(rng, b, s, h, p), np.logaddexp(_randn(rng, b, s, h), 0).astype(np.float32)
    a = np.array([-16.0, -12.0], np.float32)
    bm, cm = _randn(rng, b, s, g, n), _randn(rng, b, s, g, n)
    st, ys = np.zeros((b, h, p, n)), []
    for t in range(s):
        st = st * np.exp(dt[:, t].astype(np.float64) * a)[..., None, None] + np.einsum(
            "bhp,bhn->bhpn", x[:, t] * dt[:, t, :, None].astype(np.float64),
            np.repeat(bm[:, t], h, 1).astype(np.float64))
        ys.append(np.einsum("bhpn,bhn->bhp", st, np.repeat(cm[:, t], h, 1)))
    y64 = np.stack(ys, 1)
    yj, _ = ssd_chunked_ref(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)), 256)
    yt, ft = TS.ssd_chunked(*(torch.from_numpy(v) for v in (x, dt, a, bm, cm)), 256)
    err_port = np.abs(_np(yt) - y64).max()
    err_ref = np.abs(_np(yj) - y64).max()
    assert err_port < 5e-5 and err_port < err_ref / 5, (err_port, err_ref)
    np.testing.assert_allclose(_np(ft), st, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# mixer pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [2, 3, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv(s, dtype):
    """Shorter than, equal to and longer than the conv's d_conv - 1 = 3."""
    rng = np.random.default_rng(6)
    xbc, w, bias = _randn(rng, 2, s, 24), _randn(rng, 24, 4) * 0.1, _randn(rng, 24)
    jd, td = DTYPES[dtype]
    want = JS._causal_conv(jnp.asarray(xbc, jd), jnp.asarray(w, jd), jnp.asarray(bias, jd))
    got = TS._causal_conv(torch.from_numpy(xbc).to(td), torch.from_numpy(w).to(td),
                          torch.from_numpy(bias).to(td))
    assert got.dtype == td
    np.testing.assert_allclose(_np(got), _np(want), **(F32 if dtype == "float32" else BF16))


def test_softplus_is_jax_softplus_above_torch_threshold():
    """torch's softplus returns x above 20; jax.nn.softplus does not."""
    x = np.array([-40, -5, 0, 5, 19.9, 20, 20.1, 25, 40, 90], np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = TS._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -23, atol=0)


def _mamba_params(seed, dtype, dt_bias=0.0):
    jd, _ = DTYPES[dtype]
    jscfg, tscfg = JSSMConfig(**SCFG), TSSMConfig(**SCFG)
    jp = JS.init_mamba(jax.random.PRNGKey(seed), D_MODEL, jscfg, jd)
    jp = dict(jp, dt_bias=jp["dt_bias"] + dt_bias,
              conv_b=(0.1 * jax.random.normal(jax.random.PRNGKey(seed + 1),
                                              jp["conv_b"].shape)).astype(jd),
              norm=(0.1 * jax.random.normal(jax.random.PRNGKey(seed + 2),
                                            jp["norm"].shape)).astype(jd))
    tp = {k: _torch_like(v) for k, v in jp.items()}
    return jp, tp, jscfg, tscfg


@pytest.fixture(scope="module")
def mamba_runs():
    """Per (dtype, dt_bias): mamba_forward over a ragged 45-token prompt
    (two chunks of 32) and 3 decode steps, in both packages."""
    out = {}
    for dtype, dt_bias in (("float32", 0.0), ("bfloat16", 0.0), ("float32", 25.0)):
        jd, td = DTYPES[dtype]
        jp, tp, jscfg, tscfg = _mamba_params(7, dtype, dt_bias)
        x = _randn(np.random.default_rng(8), 2, 48, D_MODEL)
        jy, jc = jax.jit(lambda p, x: JS.mamba_forward(p, x, D_MODEL, jscfg))(
            jp, jnp.asarray(x[:, :45], jd))
        ty, tc = TS.mamba_forward(tp, torch.from_numpy(x[:, :45]).to(td), D_MODEL, tscfg)
        jdec = jax.jit(lambda p, x, c: JS.mamba_decode(p, x, c, D_MODEL, jscfg))
        steps = []
        for t in range(45, 48):
            jo, jc = jdec(jp, jnp.asarray(x[:, t:t + 1], jd), jc)
            to, tc = TS.mamba_decode(tp, torch.from_numpy(x[:, t:t + 1]).to(td), tc,
                                     D_MODEL, tscfg)
            steps.append((_np(jo), _np(to), jax.tree.map(_np, jc),
                          {k: _np(v) for k, v in tc.items()}))
        out[(dtype, dt_bias)] = dict(forward=(_np(jy), _np(ty)), steps=steps, cache=tc)
    return out


@pytest.mark.parametrize("case", [("float32", 0.0), ("bfloat16", 0.0), ("float32", 25.0)],
                         ids=["f32", "bf16", "f32_dt_raw_above_20"])
def test_mamba_forward_and_decode_match_reference(mamba_runs, case):
    run = mamba_runs[case]
    tol = F32 if case[0] == "float32" else BF16
    np.testing.assert_allclose(run["forward"][1], run["forward"][0], **tol)
    for jo, to, jc, tc in run["steps"]:
        np.testing.assert_allclose(to, jo, **tol)
        for key in ("conv", "state"):
            np.testing.assert_allclose(tc[key], jc[key], **tol)


def test_mamba_caches_keep_their_types(mamba_runs):
    cache = mamba_runs[("bfloat16", 0.0)]["cache"]
    assert cache["conv"].dtype == torch.bfloat16 and cache["conv"].shape == (2, 3, 128 + 32)
    assert cache["state"].dtype == torch.float32 and cache["state"].shape == (2, 4, 32, 16)


# ---------------------------------------------------------------------------
# model and engine
# ---------------------------------------------------------------------------
def test_forward_equals_prefill_plus_decode():
    """The property of tests/test_long_context.py on the port: decoding
    past a prefill of half the sequence gives the full forward's logits."""
    cfg = TC.get_config("mamba2-2.7b", reduced=True)
    params = TM.init(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (1, 80)))
    with torch.inference_mode():
        full = TM.logits(params, cfg, TM.forward(params, cfg, {"tokens": toks})[0])
        _, caches, clen = TM.prefill(params, cfg, {"tokens": toks[:, :40]})
        errs = []
        for t in range(40, 80):
            lg, caches = TM.decode_step(params, cfg, caches, clen, toks[:, t:t + 1])
            errs.append((lg - full[:, t]).abs().max().item())
            clen += 1
    assert max(errs) < 5e-4, errs


def test_bf16_model_keeps_decay_parameters_in_f32():
    jcfg = dataclasses.replace(JC.get_config("mamba2-2.7b", reduced=True), dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(TC.get_config("mamba2-2.7b", reduced=True), dtype=torch.bfloat16)
    jparams = jax.jit(JM.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    for params in (convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                           device="cpu"),
                   TM.init(tcfg, device="cpu")):
        for layer in params["stack"]:
            ssm = layer["ssm"]
            for key in ("A_log", "D", "dt_bias"):
                assert ssm[key].dtype == torch.float32, key
            for key in ("in_proj", "conv_w", "conv_b", "norm", "out_proj"):
                assert ssm[key].dtype == torch.bfloat16, key
        assert TM.init_cache(tcfg, 1, 8, device="cpu")[0]["state"].dtype == torch.float32
    lam = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  device="cpu")["stack"][0]["ssm"]["A_log"]
    np.testing.assert_array_equal(lam.numpy(), np.asarray(jparams["stack"]["blocks"][0]
                                                          ["ssm"]["A_log"][0]))


GEN = 4


def _prompt(seed):
    return np.random.default_rng(seed).integers(0, 500, (2, 40)).astype(np.int32)


@pytest.fixture(scope="module")
def mamba_servers():
    """The reference and port StageServers over the first two mamba2
    variants on shared weights, and the reference's tokens per variant."""
    jfam = JC.get_variant_family("mamba2-2.7b")[:2]
    tfam = TC.get_variant_family("mamba2-2.7b")[:2]
    jp, tp = {}, {}
    for i, ((name, jcfg, _), (_, tcfg, _)) in enumerate(zip(jfam, tfam)):
        jp[name] = jax.jit(JM.init, static_argnums=1)(jax.random.PRNGKey(20 + i), jcfg)
        tp[name] = convert.params_from_jax(jax.tree.map(np.asarray, jp[name]), tcfg,
                                           device="cpu")
    jsrv = JE.StageServer("mamba2-2.7b", jfam, gen_tokens=GEN, params_by_variant=jp)
    tsrv = TE.StageServer("mamba2-2.7b", tfam, gen_tokens=GEN, params_by_variant=tp,
                          device="cpu")
    want = {}
    for i, (name, jcfg, _) in enumerate(jfam):
        jsrv.set_variant(name)
        gen = jsrv.process(_prompt(i))[0]
        # the reference's logits of the prompt and of its own tokens, step by step
        pre = jax.jit(lambda p, t, c=jcfg: JM.prefill(p, c, {"tokens": t})[:2])
        dec = jax.jit(lambda p, c_, n, t, c=jcfg: JM.decode_step(p, c, c_, n, t))
        hl, caches = pre(jp[name], jnp.asarray(_prompt(i)))
        lgs = [np.asarray(hl @ jp[name]["embed"].T)]
        for t in range(GEN - 1):
            lg, caches = dec(jp[name], caches, jnp.int32(_prompt(i).shape[1] + t),
                             jnp.asarray(gen[:, t:t + 1]))
            lgs.append(np.asarray(lg))
        want[name] = (gen, np.stack(lgs))
    return jsrv, tsrv, want


@pytest.mark.parametrize("variant", [0, 1])
def test_stage_server_matches_reference_engine(mamba_servers, variant):
    """Per-step logits of the prompt and the reference's generated tokens
    through both models (teacher-forced, f32 2e-4), then the tokens of each
    engine's own greedy loop up to the first step whose reference top-2
    margin is within the tolerance; switching to the variant selects its
    weights and accuracy."""
    jsrv, tsrv, want = mamba_servers
    name = list(tsrv.variants)[variant]
    tsrv.set_variant(name)
    assert tsrv.active == name and tsrv.accuracy == jsrv.variants[name][1]
    params, tcfg = tsrv.params[name], tsrv.config
    prompt, (gen, jl) = _prompt(variant), want[name]
    s = prompt.shape[1]
    with torch.inference_mode():
        thl, tc, _ = TM.prefill(params, tcfg,
                                {"tokens": torch.from_numpy(prompt.astype(np.int64))})
        tl = [_np(thl @ params["embed"].T)]
        for t in range(GEN - 1):
            lg, tc = TM.decode_step(params, tcfg, tc, s + t,
                                    torch.from_numpy(gen[:, t:t + 1].astype(np.int64)))
            tl.append(_np(lg))
    np.testing.assert_allclose(np.stack(tl), jl, **F32)
    top = np.sort(jl, axis=-1)[..., -2:]
    clear = (top[..., 1] - top[..., 0] > F32["atol"]).all(axis=1)
    n = int(np.argmin(clear)) if not clear.all() else GEN
    assert n >= 2, "the seed should give clear margins for most steps"
    got, lat = tsrv.process(prompt)
    assert got.shape == (2, GEN) and got.dtype == np.int32 and lat > 0
    np.testing.assert_array_equal(got[:, :n], gen[:, :n])


@pytest.fixture(scope="module")
def nlp_chain():
    """build_pipeline's gemma3 -> qwen2-moe -> mamba2 on the CPU."""
    return serve.build_pipeline("nlp-chain", gen_tokens=2, profile_batches=(1, 2),
                                verbose=False, device="cpu")


def test_nlp_chain_builds_three_stage_models(nlp_chain):
    """Every stage's family is profiled into a StageModel (a variant that
    cannot meet the throughput floor on a busy CPU is left out, as
    build_stage does)."""
    pipe, _ = nlp_chain
    assert [st.name for st in pipe.stages] == ["gemma3-27b", "qwen2-moe-a2.7b",
                                               "mamba2-2.7b"]
    for st in pipe.stages:
        assert isinstance(st, StageModel) and 1 <= len(st.variants) <= 3 and st.sla > 0


def test_nlp_chain_engine_serves_the_chain(nlp_chain):
    _, engine = nlp_chain
    out, lats = engine.serve(np.zeros((1, 4), np.int32))
    assert out.shape == (1, 2) and out.dtype == np.int32 and len(lats) == 3
    assert ((out >= 0) & (out < engine.stages[-1].config.vocab)).all()
