"""repro_torch.models.model against repro.models.model on the reference's own
parameters (``repro.models.model.init``, converted through numpy).

For each reduced architecture of the vlm-classify path, the two
sliding-window families, mamba2, the MoE families (qwen2-moe, kimi-k2) and
the hybrid jamba, the same tokens (and patches) go through ``forward``,
``prefill`` and several ``decode_step``s of both packages; the hidden
states, the MoE balancing loss, logits and caches (KV, or Mamba2's conv
window and SSM state) must agree.  The MoE cases run in both dispatch
modes, each package in the same one, and one of them with a capacity
factor small enough that pairs are dropped (ROADMAP R5).  A MoE token whose
k-th and (k+1)-th router probabilities lie within 1e-6 could route either
way in either package: such tokens are counted and printed, and a case
that has any is compared on greedy tokens only.  The sliding-window cases decode across the
window boundary and prefill past it, so the ring buffer wraps both ways
(the pattern of tests/test_long_context.py); the mamba2 cases prefill a
ragged tail past a whole chunk and a prompt shorter than the conv window.
The reference runs its naive attention and its jnp SSD path; the port runs
``impl="kernel"``, which on the CPU is each kernel's plain version.

Tolerances are the reference's: 2e-4 for f32, 2e-2 for bf16.  In bf16 the
two frameworks round their elementwise ops differently (XLA's CPU logistic,
``jax.nn.gelu``'s constants rounded to bf16, bf16 matmul rounding), which
puts whole-model logits a few bf16 ulps apart, beyond 2e-2 in a few
elements; the bf16 case therefore compares greedy tokens where the top-2
margin exceeds the tolerance, and the numbers are held at f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import model as JM
from repro.models import stack as JS
from repro_torch import configs as TC
from repro_torch.core import profiler as TPF
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.models import moe as TMO

F32 = dict(atol=2e-4, rtol=2e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)

# name: (arch, n_layers, d_model, dtype, prompt, decode steps, patches)
CASES = {
    "yi": ("yi-34b", 2, 128, "float32", 10, 3, False),
    "yi_bf16": ("yi-34b", 2, 128, "bfloat16", 10, 2, False),
    "phi3": ("phi-3-vision-4.2b", 2, 384, "float32", 9, 3, False),
    "phi3_patches": ("phi-3-vision-4.2b", 2, 128, "float32", 7, 3, True),
    "starcoder2_ring": ("starcoder2-3b", 2, 128, "float32", 60, 8, False),
    "starcoder2_roll": ("starcoder2-3b", 2, 128, "float32", 70, 3, False),
    "gemma3_ring": ("gemma3-27b", 2, 128, "float32", 60, 8, False),
    "gemma3_roll": ("gemma3-27b", 2, 128, "float32", 70, 3, False),
    "mamba2": ("mamba2-2.7b", 2, 128, "float32", 45, 4, False),
    "mamba2_short": ("mamba2-2.7b", 2, 128, "float32", 2, 4, False),
    "mamba2_bf16": ("mamba2-2.7b", 2, 128, "bfloat16", 40, 2, False),
    "qwen2_moe": ("qwen2-moe-a2.7b", 2, 128, "float32", 10, 3, False),
    "qwen2_moe_gather": ("qwen2-moe-a2.7b", 2, 128, "float32", 10, 3, False),
    "qwen2_moe_drops": ("qwen2-moe-a2.7b", 2, 128, "float32", 10, 3, False),
    "qwen2_moe_drops_gather": ("qwen2-moe-a2.7b", 2, 128, "float32", 10, 3, False),
    "qwen2_moe_bf16": ("qwen2-moe-a2.7b", 2, 128, "bfloat16", 10, 2, False),
    "kimi_k2": ("kimi-k2-1t-a32b", 2, 128, "float32", 10, 3, False),
    "kimi_k2_gather": ("kimi-k2-1t-a32b", 2, 128, "float32", 10, 3, False),
    "jamba": ("jamba-v0.1-52b", 2, 128, "float32", 45, 3, False),
    "jamba_gather": ("jamba-v0.1-52b", 2, 128, "float32", 45, 3, False),
}
# the MoE cases' dispatch, where it is not the default einsum, and their
# capacity factor, where it is not the config's: 0.5 gives capacity 6 of 20
# prefill tokens and 1 of 2 decode tokens, so pairs are dropped
GATHER = {"qwen2_moe_gather", "qwen2_moe_drops_gather", "kimi_k2_gather", "jamba_gather"}
CAPACITY_FACTOR = {"qwen2_moe_drops": 0.5, "qwen2_moe_drops_gather": 0.5}
NEAR_TIE = 1e-6
B = 2


def _configs(arch, n_layers, d_model, dtype, capacity_factor=None):
    jcfg = JC.arch_module(arch).reduced(n_layers, d_model)
    tcfg = TC.arch_module(arch).reduced(n_layers, d_model)
    if dtype == "bfloat16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
    return jcfg, tcfg


class _NearTies:
    """Counts the tokens whose k-th and (k+1)-th router probabilities lie
    within NEAR_TIE, over every routing of the port while it is active."""

    def __init__(self):
        self.count, self._top_k = 0, TMO._top_k

    def __enter__(self):
        def top_k(probs, k):
            if k < probs.shape[-1]:
                top = torch.sort(probs, dim=-1, descending=True).values
                self.count += int(((top[..., k - 1] - top[..., k]) < NEAR_TIE).sum())
            return self._top_k(probs, k)
        TMO._top_k = top_k
        return self

    def __exit__(self, *exc):
        TMO._top_k = self._top_k


def _jax_layer(tree, jcfg, i):
    """Layer i of a stacked reference pytree (params or caches)."""
    pl = JS.plan(jcfg)
    if i < pl.n_rep * pl.period:
        return jax.tree.map(lambda a: a[i // pl.period], tree["blocks"][i % pl.period])
    return tree["rem"][i - pl.n_rep * pl.period]


def _np(x):
    """A float32 numpy copy: the port updates its caches in place."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy().copy()
    return np.asarray(x, np.float32)


_RUNS = {}


def _run(name):
    """Both packages on one case; computed once per module and case."""
    if name in _RUNS:
        return _RUNS[name]
    arch, n_layers, d_model, dtype, prompt, steps, with_patches = CASES[name]
    jcfg, tcfg = _configs(arch, n_layers, d_model, dtype, CAPACITY_FACTOR.get(name))
    moe_impl = "gather" if name in GATHER else "einsum"
    rng = np.random.default_rng(0)
    total = prompt + steps
    toks = rng.integers(0, jcfg.vocab, (B, total)).astype(np.int32)
    patches = (rng.standard_normal((B, jcfg.n_patches, jcfg.d_model)).astype(np.float32)
               if with_patches else None)
    n_prefix = jcfg.n_patches if with_patches else 0
    cap = n_prefix + total

    jparams = jax.jit(JM.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")

    def jbatch(t):
        b = {"tokens": jnp.asarray(t)}
        if with_patches:
            b["patches"] = jnp.asarray(patches)
        return b

    def tbatch(t):
        b = {"tokens": torch.from_numpy(t.copy())}
        if with_patches:
            b["patches"] = torch.from_numpy(patches)
        return b

    out = {"jcfg": jcfg, "tcfg": tcfg, "dtype": dtype}

    @jax.jit
    def jfwd(p, b):
        h, aux = JM.forward(p, jcfg, b, impl="naive", moe_impl=moe_impl)
        return h, JM.logits(p, jcfg, h), aux

    h, lg, aux = jfwd(jparams, jbatch(toks))
    out["forward"] = (_np(h), _np(lg))
    out["aux"] = _np(aux)
    ties = _NearTies()
    with torch.inference_mode(), ties:
        th, taux = TM.forward(tparams, tcfg, tbatch(toks), moe_impl=moe_impl)
        out["forward_port"] = (_np(th), _np(TM.logits(tparams, tcfg, th)))
        out["aux_port"] = _np(taux)
        assert taux.shape == () and taux.dtype == torch.float32

    jpre = jax.jit(lambda p, b: JM.prefill(p, jcfg, b, impl="naive", moe_impl=moe_impl,
                                           capacity=cap)[:2])
    jdec = jax.jit(lambda p, c, n, t: JM.decode_step(p, jcfg, c, n, t, moe_impl=moe_impl))
    hl, jcaches = jpre(jparams, jbatch(toks[:, :prompt]))
    out["prefill"] = _np(hl)
    out["prefill_caches"] = [jax.tree.map(_np, _jax_layer(jcaches, jcfg, i))
                             for i in range(jcfg.n_layers)]
    with torch.inference_mode(), ties:
        thl, tcaches, s = TM.prefill(tparams, tcfg, tbatch(toks[:, :prompt]),
                                     moe_impl=moe_impl, capacity=cap)
        out["prefill_port"] = _np(thl)
        out["prefill_caches_port"] = [{k: _np(v) for k, v in c.items()} for c in tcaches]
        assert s == n_prefix + prompt
        jl, tl = [], []
        for t in range(prompt, total):
            clen = n_prefix + t
            lg, jcaches = jdec(jparams, jcaches, jnp.int32(clen), jnp.asarray(toks[:, t:t + 1]))
            jl.append(_np(lg))
            lg, tcaches = TM.decode_step(tparams, tcfg, tcaches, clen,
                                         torch.from_numpy(toks[:, t:t + 1].copy()),
                                         moe_impl=moe_impl)
            tl.append(_np(lg))
    out["decode"], out["decode_port"] = np.stack(jl), np.stack(tl)
    out["near_ties"] = ties.count
    if tcfg.moe is not None:
        print(f"{name}: {ties.count} routings with the k-th and (k+1)-th router "
              f"probabilities within {NEAR_TIE}")
    out["decode_caches"] = [jax.tree.map(_np, _jax_layer(jcaches, jcfg, i))
                            for i in range(jcfg.n_layers)]
    out["decode_caches_port"] = [{k: _np(v) for k, v in c.items()} for c in tcaches]
    _RUNS[name] = out
    return out


def _tol(run):
    return BF16 if run["dtype"] == "bfloat16" else F32


F32_CASES = [name for name, case in CASES.items() if case[3] == "float32"]


@pytest.fixture(scope="module")
def run(request):
    return _run(request.param)


def _greedy_only(run):
    """A case with a near tie in routing: its greedy tokens, where the
    reference's top-2 margin exceeds the tolerance, must agree."""
    if not run["near_ties"]:
        return False
    for got, want in ((run["forward_port"][1], run["forward"][1]),
                      (run["decode_port"], run["decode"])):
        clear = _top2_margin(want) > _tol(run)["atol"]
        np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
    return True


@pytest.mark.parametrize("run", F32_CASES, indirect=True)
def test_forward_hidden_and_logits(run):
    if _greedy_only(run):
        return
    for got, want in zip(run["forward_port"], run["forward"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **_tol(run))
    np.testing.assert_allclose(run["aux_port"], run["aux"], **_tol(run))
    if run["tcfg"].moe is None:
        assert run["aux_port"] == 0.0


@pytest.mark.parametrize("run", F32_CASES, indirect=True)
def test_prefill_hidden_and_caches(run):
    if _greedy_only(run):
        return
    np.testing.assert_allclose(run["prefill_port"], run["prefill"], **_tol(run))
    for got, want in zip(run["prefill_caches_port"], run["prefill_caches"]):
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].shape == want[key].shape, key
            np.testing.assert_allclose(got[key], want[key], **_tol(run))


@pytest.mark.parametrize("run", F32_CASES, indirect=True)
def test_decode_logits_and_caches(run):
    if _greedy_only(run):
        return
    np.testing.assert_allclose(run["decode_port"], run["decode"], **_tol(run))
    for got, want in zip(run["decode_caches_port"], run["decode_caches"]):
        for key in want:
            np.testing.assert_allclose(got[key], want[key], **_tol(run))


def _top2_margin(lg):
    top = np.sort(lg, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


@pytest.mark.parametrize("run", ["yi_bf16", "mamba2_bf16", "qwen2_moe_bf16"], indirect=True)
def test_bf16_greedy_tokens_agree_where_the_margin_allows(run):
    want = np.concatenate([run["forward"][1], run["decode"].transpose(1, 0, 2)], axis=1)
    got = np.concatenate([run["forward_port"][1], run["decode_port"].transpose(1, 0, 2)],
                         axis=1)
    clear = _top2_margin(want) > BF16["atol"]
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


@pytest.mark.parametrize("run", ["gemma3_roll"], indirect=True)
def test_window_layers_keep_a_ring_of_window_slots(run):
    """gemma3 with global_every=2: layer 0 is local (ring of 64 slots),
    layer 1 global (the full capacity)."""
    caps = [c["k"].shape[1] for c in run["prefill_caches_port"]]
    assert caps == [64, 73]


def test_prompt_longer_than_cache_raises():
    _, tcfg = _configs("yi-34b", 1, 128, "float32")
    params = TM.init(tcfg, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        TM.prefill(params, tcfg, {"tokens": torch.zeros((1, 12), dtype=torch.int64)},
                   capacity=8)


def test_whisper_builds_with_the_ports_own_init():
    """Parity with the reference is in tests/test_torch_encdec.py."""
    cfg = TC.get_config("whisper-medium", reduced=True)
    params = TM.init(cfg, device="cpu")
    assert len(params["enc_stack"]) == cfg.n_encoder_layers
    assert params["enc_norm"].shape == (cfg.d_model,)
    assert all({"ln_x", "cross"} <= set(p) for p in params["stack"])
    assert not any("cross" in p for p in params["enc_stack"])
    frames = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    toks = torch.zeros((1, 5), dtype=torch.int64)
    with torch.inference_mode():
        hl, caches, s = TM.prefill(params, cfg, {"tokens": toks, "frames": frames},
                                   capacity=6)
        lg, _ = TM.decode_step(params, cfg, caches, s, toks[:, :1])
    assert lg.shape == (1, cfg.vocab) and bool(torch.isfinite(lg).all())


def test_asr_qa_pipeline_raises_before_profiling_naming_r2(monkeypatch):
    def never(*a, **k):
        raise AssertionError("profiled a stage")
    monkeypatch.setattr(TPF, "profile_stage_server", never)
    monkeypatch.setattr(serve, "StageServer", never)
    with pytest.raises(NotImplementedError, match="R2"):
        serve.build_pipeline("asr-qa", verbose=False, device="cpu")
