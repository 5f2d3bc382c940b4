"""repro_torch.serving.engine against repro.serving.engine on shared weights.

Both engines get the same variant weights through ``params_by_variant``
(the reference's ``repro.models.model.init``, converted through numpy for
the port) and the same prompts.  Greedy tokens are compared only where the
reference's top-2 logit margin exceeds the f32 tolerance (2e-4): up to the
first step whose margin does not, both engines must emit the same tokens.
The stages are those of vlm-classify (phi-3-vision -> yi-34b) and
nlp-chain (gemma3 -> qwen2-moe -> mamba2), whose whole chain is also held
against the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import model as JM
from repro.serving import engine as JE
from repro_torch import configs as TC
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.serving import engine as TE

TOL = 2e-4
GEN = 4


def _family(arch, k=2):
    return JC.get_variant_family(arch)[:k], TC.get_variant_family(arch)[:k]


def _weights(jfam, tfam):
    jp, tp = {}, {}
    for i, ((name, jcfg, _), (_, tcfg, _)) in enumerate(zip(jfam, tfam)):
        jp[name] = jax.jit(JM.init, static_argnums=1)(jax.random.PRNGKey(10 + i), jcfg)
        tp[name] = convert.params_from_jax(jax.tree.map(np.asarray, jp[name]), tcfg,
                                           device="cpu")
    return jp, tp


def _clear_steps(jparams, jcfg, prompt, gen):
    """How many leading generated tokens have a reference top-2 margin above
    the tolerance, from one teacher-forced forward over prompt + gen."""
    toks = np.concatenate([np.asarray(prompt, np.int32) % jcfg.vocab, gen], axis=1)
    h, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)}, impl="naive")
    lg = np.asarray(JM.logits(jparams, jcfg, h))[:, prompt.shape[1] - 1:-1]
    top = np.sort(lg, axis=-1)[..., -2:]
    clear = (top[..., 1] - top[..., 0] > TOL).all(axis=0)
    return int(np.argmin(clear)) if not clear.all() else gen.shape[1]


def _prompt(seed):
    return np.random.default_rng(seed).integers(0, 1000, (2, 8)).astype(np.int32)


ARCHS = ("phi-3-vision-4.2b", "yi-34b", "gemma3-27b", "qwen2-moe-a2.7b", "mamba2-2.7b")


@pytest.fixture(scope="module")
def servers():
    """Per stage of vlm-classify and nlp-chain: the reference and port
    StageServers on shared weights, and the reference's tokens and clear
    steps for the prompt of each variant."""
    out = {}
    for arch in ARCHS:
        jfam, tfam = _family(arch)
        jp, tp = _weights(jfam, tfam)
        jsrv = JE.StageServer(arch, jfam, gen_tokens=GEN, params_by_variant=jp)
        tsrv = TE.StageServer(arch, tfam, gen_tokens=GEN, params_by_variant=tp,
                              device="cpu")
        want = {}
        for i, name in enumerate(jsrv.variants):
            jsrv.set_variant(name)
            toks, _ = jsrv.process(_prompt(i))
            want[name] = (toks, _clear_steps(jp[name], jsrv.config, _prompt(i), toks))
        out[arch] = (jsrv, tsrv, jp, want)
    return out


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "yi-34b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("variant", [0, 1])
def test_stage_server_tokens_match_reference(servers, arch, variant):
    _, tsrv, _, ref = servers[arch]
    name = list(tsrv.variants)[variant]
    want, n = ref[name]
    tsrv.set_variant(name)
    got, lat = tsrv.process(_prompt(variant))
    assert got.shape == want.shape == (2, GEN) and got.dtype == np.int32
    assert lat > 0
    assert n >= 2, "the seed should give clear margins for most steps"
    np.testing.assert_array_equal(got[:, :n], want[:, :n])


@pytest.fixture(scope="module")
def pipeline_reference(servers):
    """The reference pipeline's output on the first variants, with the clear
    steps of both stages."""
    stages = [servers["phi-3-vision-4.2b"], servers["yi-34b"]]
    names = [list(s[0].variants)[0] for s in stages]
    jeng = JE.PipelineEngine([s[0] for s in stages])
    jeng.configure(names)
    prompt = _prompt(5)
    mid = stages[0][0].process(prompt)[0]
    want, _ = jeng.serve(prompt)
    clear = (_clear_steps(stages[0][2][names[0]], stages[0][0].config, prompt, mid),
             _clear_steps(stages[1][2][names[1]], stages[1][0].config, mid, want))
    return names, prompt, want, clear, jeng.pas


def test_pipeline_engine_serve_matches_reference(servers, pipeline_reference):
    names, prompt, want, (clear_mid, clear_out), pas = pipeline_reference
    teng = TE.PipelineEngine([servers["phi-3-vision-4.2b"][1], servers["yi-34b"][1]])
    teng.configure(names)
    got, lats = teng.serve(prompt)
    assert clear_mid == GEN, "stage 2's prompt must not depend on a near tie"
    np.testing.assert_array_equal(got[:, :clear_out], want[:, :clear_out])
    assert len(lats) == 2 and all(l > 0 for l in lats)
    assert teng.pas == pas


NLP_CHAIN = ("gemma3-27b", "qwen2-moe-a2.7b", "mamba2-2.7b")


@pytest.fixture(scope="module")
def nlp_chain_reference(servers):
    """The reference chain on the first variants: each stage's prompt,
    tokens and clear steps, and the pipeline's PAS."""
    stages = [servers[a] for a in NLP_CHAIN]
    names = [list(s[0].variants)[0] for s in stages]
    jeng = JE.PipelineEngine([s[0] for s in stages])
    jeng.configure(names)
    cur, steps = _prompt(6), []
    for (jsrv, _, jp, _), name in zip(stages, names):
        want = jsrv.process(cur)[0]
        steps.append((cur, want, _clear_steps(jp[name], jsrv.config, cur, want)))
        cur = want
    return names, steps, jeng.pas


def test_nlp_chain_serve_matches_reference(servers, nlp_chain_reference):
    """gemma3 -> qwen2-moe -> mamba2 on the first variants: each stage's
    tokens up to its clear steps, and the chain's output wherever every
    earlier stage's tokens were clear."""
    names, steps, pas = nlp_chain_reference
    tsrvs = [servers[a][1] for a in NLP_CHAIN]
    teng = TE.PipelineEngine(tsrvs)
    teng.configure(names)
    for tsrv, (prompt, want, clear) in zip(tsrvs, steps):
        np.testing.assert_array_equal(tsrv.process(prompt)[0][:, :clear], want[:, :clear])
    assert [c for _, _, c in steps[:2]] == [GEN, GEN], \
        "a later stage's prompt must not depend on a near tie"
    got, lats = teng.serve(steps[0][0])
    np.testing.assert_array_equal(got[:, :steps[2][2]], steps[2][1][:, :steps[2][2]])
    assert len(lats) == 3 and all(l > 0 for l in lats)
    assert teng.pas == pas


R4_GEN, R4_MAX_CTX = 6, 10


@pytest.fixture(scope="module", params=["yi-34b", "phi-3-vision-4.2b", "mamba2-2.7b"])
def r4_reference(request):
    """One variant of the family on shared weights: the reference engine's
    tokens with max_ctx 10, and its logits along them (prefill, then decode
    steps over the cache of 10 slots)."""
    jfam, tfam = _family(request.param, 1)
    jp, tp = _weights(jfam, tfam)
    name, jcfg, _ = jfam[0]
    jsrv = JE.StageServer(request.param, jfam, gen_tokens=R4_GEN, max_ctx=R4_MAX_CTX,
                          params_by_variant=jp)
    prompt = _prompt(7) % jcfg.vocab
    want = jsrv.process(prompt)[0]
    s = prompt.shape[1]
    hl, caches = jax.jit(lambda p, t: JM.prefill(p, jcfg, {"tokens": t}, impl="naive",
                                                 capacity=R4_MAX_CTX)[:2])(
        jp[name], jnp.asarray(prompt))
    logits = [np.asarray(hl @ jp[name]["embed"].T)]
    dec = jax.jit(lambda p, c, n, t: JM.decode_step(p, jcfg, c, n, t))
    for t in range(R4_GEN - 1):
        lg, caches = dec(jp[name], caches, jnp.int32(s + t), jnp.asarray(want[:, t:t + 1]))
        logits.append(np.asarray(lg))
    return tfam, tp[name], prompt, want, np.stack(logits)


def test_full_attention_cache_wraps_as_the_reference_does(r4_reference):
    """ROADMAP R4: with max_ctx 10, a prompt of 8 and 6 generated tokens the
    engines' cache holds 10 slots, so decode overwrites the oldest position
    and a full-attention layer attends over the last 10 only.  The port's
    tokens equal the reference's, and its logits along the reference's
    tokens are within 2e-4 at every step."""
    tfam, params, prompt, want, jl = r4_reference
    tsrv = TE.StageServer("s", tfam, gen_tokens=R4_GEN, max_ctx=R4_MAX_CTX,
                          params_by_variant={tfam[0][0]: params}, device="cpu")
    np.testing.assert_array_equal(tsrv.process(prompt)[0], want)
    cfg, s = tfam[0][1], prompt.shape[1]
    with torch.inference_mode():
        hl, caches, _ = TM.prefill(params, cfg, {"tokens": torch.from_numpy(
            prompt.astype(np.int64))}, capacity=R4_MAX_CTX)
        tl = [(hl @ params["embed"].T).numpy()]
        for t in range(R4_GEN - 1):
            lg, caches = TM.decode_step(params, cfg, caches, s + t, torch.from_numpy(
                want[:, t:t + 1].astype(np.int64)))
            tl.append(lg.numpy())
    assert s + R4_GEN - 1 > R4_MAX_CTX      # the last steps write over the oldest slots
    np.testing.assert_allclose(np.stack(tl), jl, atol=TOL, rtol=TOL)


def test_switching_and_accuracy(servers):
    tsrv = servers["yi-34b"][1]
    names = list(tsrv.variants)
    tsrv.set_variant(names[1])
    assert tsrv.active == names[1] and tsrv.accuracy == tsrv.variants[names[1]][1]
    with pytest.raises(KeyError):
        tsrv.set_variant("no-such-variant")


def test_cpu_engine_launches_no_kernel(servers):
    tsrv = servers["yi-34b"][1]
    before = (tfa.flash_attention.launches, tdec.decode_attention.launches)
    tsrv.process(np.zeros((1, 5), np.int32))
    assert (tfa.flash_attention.launches, tdec.decode_attention.launches) == before


def test_prompt_longer_than_max_ctx_raises():
    tfam = TC.get_variant_family("yi-34b")[:1]
    srv = TE.StageServer("s", tfam, gen_tokens=2, max_ctx=6, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        srv.process(np.zeros((1, 8), np.int32))


def test_own_init_is_seeded():
    tfam = TC.get_variant_family("yi-34b")[:1]
    a = TE.StageServer("s", tfam, seed=3, device="cpu")
    b = TE.StageServer("s", tfam, seed=3, device="cpu")
    name = tfam[0][0]
    assert torch.equal(a.params[name]["embed"], b.params[name]["embed"])
    prompt = np.arange(12, dtype=np.int32).reshape(2, 6)
    np.testing.assert_array_equal(a.process(prompt)[0], b.process(prompt)[0])
