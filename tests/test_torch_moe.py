"""repro_torch.models.moe against repro.models.moe.

The same inputs, numpy arrays from a seed, go to both packages; parameters
are the reference's own (``init_moe``), converted through numpy with
``convert``'s leaf conversion.  f32 at the reference's 2e-4.  The cases
cover shared experts (qwen2-moe) and none (jamba), one routing group,
several (``group_size``), a token count the group size does not divide,
and a capacity factor small enough that (token, expert) pairs are dropped
(ROADMAP R5), in both dispatch modes, each against the reference's same
mode.  A token whose k-th and (k+1)-th router probabilities (the
reference's) lie within 1e-6 may route either way in either package: such
tokens are counted and printed, and their outputs are left out of the
elementwise comparison.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs.base import MoEConfig as JMoE
from repro.models import model as JM
from repro.models import moe as JMO
from repro_torch import configs as TC
from repro_torch import tracing
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.kernels import moe_experts as KX
from repro_torch.kernels import ops as KO
from repro_torch.models import convert
from repro_torch.models import moe as TMO

F32 = dict(atol=2e-4, rtol=2e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
NEAR_TIE = 1e-6
D = 32
# the reference's functions, jitted with the config static (eager JAX
# compiles every primitive at each new shape)
j_init_moe = jax.jit(JMO.init_moe, static_argnums=(1, 2, 3, 4))
j_moe_apply = jax.jit(JMO.moe_apply, static_argnums=2, static_argnames=("impl", "group_size"))
j_route = jax.jit(JMO._route, static_argnums=2)
j_positions = jax.jit(JMO._positions_in_expert, static_argnums=(1, 2))
j_positions_grouped = jax.jit(JMO._positions_in_expert_grouped, static_argnums=(1, 2))


def _mcfgs(**kw):
    return JMoE(**kw), TMoE(**kw)


def _params(jm, gated=True, seed=0, dtype=jnp.float32):
    jp = j_init_moe(jax.random.PRNGKey(seed), D, jm, gated, dtype)
    tp = convert._map(jax.tree.map(np.asarray, jp), lambda a: convert._tensor(a, "cpu"))
    return jp, tp


def _x(seed, b, s, d=D):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


# -- routing arithmetic -------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_capacity_matches_reference(arch, reduced):
    jm = JC.get_config(arch, reduced=reduced).moe
    tm = TC.get_config(arch, reduced=reduced).moe
    for t in list(range(1, 70)) + [127, 128, 256, 1000, 1024, 4096, 5120]:
        for cf in (tm.capacity_factor, 0.01, 0.5, 4.0):
            assert TMO._capacity(t, dataclasses.replace(tm, capacity_factor=cf)) == \
                JMO._capacity(t, dataclasses.replace(jm, capacity_factor=cf)), (t, cf)


def test_capacity_of_the_qwen2_moe_decode_step_is_one():
    """R5: at B 4 a decode step routes 4 tokens; each expert takes one pair."""
    assert TMO._capacity(4, TC.get_config("qwen2-moe-a2.7b").moe) == 1
    assert TMO._capacity(1024, TC.get_config("qwen2-moe-a2.7b").moe) == 86


@pytest.mark.parametrize("e,k,t,g", [(4, 2, 16, 1), (6, 3, 25, 1), (60, 4, 40, 1),
                                     (8, 2, 12, 3), (5, 1, 7, 4)])
def test_positions_in_expert_match_reference(e, k, t, g):
    jm, tm = _mcfgs(n_experts=e, top_k=k, d_ff_expert=8)
    rng = np.random.default_rng(e * t + g)
    top_i = np.stack([np.stack([rng.permutation(e)[:k] for _ in range(t)]) for _ in range(g)])
    want = np.asarray(j_positions_grouped(jnp.asarray(top_i), jm, t))
    got = TMO._positions_in_expert_grouped(torch.from_numpy(top_i), tm, cap=t)
    np.testing.assert_array_equal(got.numpy(), want)
    for j in range(g):
        np.testing.assert_array_equal(
            TMO._positions_in_expert(torch.from_numpy(top_i[j]), tm, cap=t).numpy(),
            np.asarray(j_positions(jnp.asarray(top_i[j]), jm, t)))


def test_route_matches_reference():
    jm, tm = _mcfgs(n_experts=8, top_k=3, d_ff_expert=16)
    jp, tp = _params(jm)
    x = _x(1, 1, 40)[0]
    jw, ji, jaux = j_route(jp, jnp.asarray(x), jm)
    tw, ti, taux = TMO._route(tp, torch.from_numpy(x), tm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **F32)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), **F32)
    assert tw.dtype == taux.dtype == torch.float32 and taux.shape == ()


def test_route_breaks_exact_ties_towards_the_lower_expert():
    """A zero router gives four equal probabilities: jax.lax.top_k takes
    experts 0 and 1, and so must the port (torch.topk need not)."""
    jm, tm = _mcfgs(n_experts=4, top_k=2, d_ff_expert=16)
    jp, tp = _params(jm)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x(2, 1, 5)[0]
    _, ji, _ = j_route(jp, jnp.asarray(x), jm)
    tw, ti, _ = TMO._route(tp, torch.from_numpy(x), tm)
    np.testing.assert_array_equal(np.asarray(ji), [[0, 1]] * 5)
    np.testing.assert_array_equal(ti.numpy(), [[0, 1]] * 5)
    np.testing.assert_array_equal(tw.numpy(), np.full((5, 2), 0.5, np.float32))


# -- the layer ----------------------------------------------------------------
QWEN = dict(n_experts=6, top_k=4, d_ff_expert=48, n_shared_experts=2, d_ff_shared=64,
            capacity_factor=1.25)
JAMBA = dict(n_experts=4, top_k=2, d_ff_expert=64, capacity_factor=1.25)
# name: (moe config, gated, B, S, group_size)
LAYER_CASES = {
    "shared_one_group": (QWEN, True, 2, 12, 4096),
    "shared_three_groups": (QWEN, True, 2, 12, 8),
    "shared_group_does_not_divide": (QWEN, True, 2, 12, 7),
    "no_shared_one_group": (JAMBA, True, 3, 10, 4096),
    "no_shared_two_groups": (JAMBA, True, 3, 10, 15),
    "gelu_experts": (dict(QWEN, capacity_factor=2.0), False, 2, 9, 4096),
    "drops": (dict(QWEN, capacity_factor=0.3), True, 2, 16, 4096),
    "drops_in_groups": (dict(JAMBA, capacity_factor=0.25), True, 4, 8, 16),
}


def _near_ties(jp, x, jm):
    """Mask (B, S) of tokens whose reference k-th and (k+1)-th router
    probabilities lie within NEAR_TIE."""
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1))
    top = np.sort(probs, axis=-1)[..., ::-1]
    return (top[..., jm.top_k - 1] - top[..., jm.top_k]) < NEAR_TIE


def _reference_drops(jp, x, jm, group_size):
    """(token, expert) pairs the reference drops for capacity."""
    t = x.shape[0] * x.shape[1]
    tg = min(group_size, t)
    tg = t if t % tg else tg
    cap = JMO._capacity(tg, jm)
    _, top_i, _ = j_route(jp, jnp.asarray(x.reshape(t, -1)), jm)
    pos = j_positions_grouped(top_i.reshape(t // tg, tg, jm.top_k), jm, cap)
    return int((np.asarray(pos) >= cap).sum())


@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_apply_matches_reference(case, impl):
    kw, gated, b, s, group_size = LAYER_CASES[case]
    jm, tm = _mcfgs(**kw)
    jp, tp = _params(jm, gated, seed=3)
    x = _x(4, b, s)
    jy, jaux = j_moe_apply(jp, jnp.asarray(x), jm, impl=impl, group_size=group_size)
    ty, taux = TMO.moe_apply(tp, torch.from_numpy(x), tm, impl=impl, group_size=group_size)
    assert ty.shape == x.shape and taux.shape == () and taux.dtype == torch.float32
    ties = _near_ties(jp, x, jm)
    print(f"{case} {impl}: {int(ties.sum())} tokens with the k-th and (k+1)-th router "
          f"probabilities within {NEAR_TIE}")
    np.testing.assert_allclose(ty.numpy()[~ties], np.asarray(jy)[~ties], **F32)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), **F32)
    if case.startswith("drops"):
        assert _reference_drops(jp, x, jm, group_size) > 0


@pytest.mark.parametrize("case", ["shared_one_group", "no_shared_two_groups", "drops"])
def test_einsum_and_gather_agree(case):
    """Both modes place the same pairs in the same slots and drop the same
    ones, so they agree with drops too."""
    kw, gated, b, s, group_size = LAYER_CASES[case]
    _, tm = _mcfgs(**kw)
    _, tp = _params(JMoE(**kw), gated, seed=5)
    x = torch.from_numpy(_x(6, b, s))
    y1, a1 = TMO.moe_apply(tp, x, tm, impl="einsum", group_size=group_size)
    y2, a2 = TMO.moe_apply(tp, x, tm, impl="gather", group_size=group_size)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), **F32)
    np.testing.assert_allclose(a1.numpy(), a2.numpy(), **F32)


def test_group_size_is_the_reference_default():
    assert TMO.GROUP_SIZE == JMO.GROUP_SIZE == 4096


def test_dispatch_gather_matches_reference():
    """One group's gather dispatch with pairs dropped, against the
    reference's gather and its one-group einsum dispatch."""
    jm, tm = _mcfgs(**dict(JAMBA, capacity_factor=0.5))
    jp, tp = _params(jm, seed=7)
    x = _x(8, 1, 20)[0]
    cap = JMO._capacity(20, jm)
    jw, ji, _ = j_route(jp, jnp.asarray(x), jm)
    tw, ti, _ = TMO._route(tp, torch.from_numpy(x), tm)
    got = TMO._dispatch_gather(tp, torch.from_numpy(x), tw, ti, tm, cap).numpy()
    for ref in (JMO._dispatch_gather, JMO._dispatch_einsum):
        want = jax.jit(ref, static_argnums=(4, 5))(jp, jnp.asarray(x), jw, ji, jm, cap)
        np.testing.assert_allclose(got, np.asarray(want), **F32)


def test_bf16_layer_matches_reference_and_keeps_the_router_f32():
    jm, tm = _mcfgs(**QWEN)
    jp, tp = _params(jm, seed=9, dtype=jnp.bfloat16)
    assert tp["router"].dtype == torch.float32 and tp["w_in"].dtype == torch.bfloat16
    x = _x(10, 2, 8)
    for impl in ("einsum", "gather"):
        jy, jaux = j_moe_apply(jp, jnp.asarray(x, jnp.bfloat16), jm, impl=impl)
        ty, taux = TMO.moe_apply(tp, torch.from_numpy(x).bfloat16(), tm, impl=impl)
        assert ty.dtype == torch.bfloat16 and taux.dtype == torch.float32
        ties = _near_ties(jp, np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32), jm)
        assert not ties.any()
        np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32), **BF16)
        np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), **F32)


def test_port_init_has_the_reference_layout_and_types():
    jm, tm = _mcfgs(**QWEN)
    jp = j_init_moe(jax.random.PRNGKey(0), D, jm, True, jnp.bfloat16)
    tp = TMO.init_moe(torch.Generator().manual_seed(0), D, tm, True, torch.bfloat16)

    def same(j, t):
        assert j.keys() == t.keys()
        for key in j:
            if isinstance(j[key], dict):
                same(j[key], t[key])
            else:
                assert tuple(t[key].shape) == j[key].shape, key
                assert str(t[key].dtype)[6:] == j[key].dtype.name, key
    same(jp, tp)


# -- conversion of a whole model ----------------------------------------------
@pytest.fixture(scope="module", params=["qwen2-moe-a2.7b", "jamba-v0.1-52b"])
def converted(request):
    """A 4-layer bf16 model of the reference and its conversion."""
    arch = request.param
    jcfg = dataclasses.replace(JC.arch_module(arch).reduced(4, 64), dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(TC.arch_module(arch).reduced(4, 64), dtype=torch.bfloat16)
    jparams = jax.tree.map(np.asarray, jax.jit(JM.init, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    return jparams, tcfg, convert.params_from_jax(jparams, tcfg, device="cpu")["stack"]


def test_convert_unstacks_moe_leaves_and_keeps_the_router_f32(converted):
    """The reference stacks each pattern position's MoE dictionary along a
    leading repetition axis (router, w_in/w_gate/w_out of (E, d_in, d_out),
    a nested shared MLP); the port gets one dictionary per layer, bf16
    leaves bf16 and the router f32."""
    jparams, tcfg, layers = converted
    period = len(jparams["stack"]["blocks"])
    moe_layers = [i for i in range(4) if tcfg.is_moe_layer(i)]
    assert moe_layers and [i for i, p in enumerate(layers) if "moe" in p] == moe_layers
    m = tcfg.moe
    for i in moe_layers:
        got = layers[i]["moe"]
        want = jparams["stack"]["blocks"][i % period]["moe"]
        assert got["router"].dtype == torch.float32
        assert got["w_in"].shape == (m.n_experts, tcfg.d_model, m.d_ff_expert)
        assert got["w_out"].shape == (m.n_experts, m.d_ff_expert, tcfg.d_model)
        assert ("shared" in got) == bool(m.n_shared_experts)
        for key in ("router", "w_in", "w_gate", "w_out"):
            np.testing.assert_array_equal(got[key].float().numpy(),
                                          want[key][i // period].astype(np.float32))
            if key != "router":
                assert got[key].dtype == torch.bfloat16, key
        if "shared" in got:
            np.testing.assert_array_equal(got["shared"]["w_gate"].float().numpy(),
                                          want["shared"]["w_gate"][i // period]
                                          .astype(np.float32))


# -- decode shapes: only the experts that hold a row (kernels/moe_experts) ----
def _expert_params(e, d, f, gated, seed):
    gen = torch.Generator().manual_seed(seed)
    p = {"w_in": TMO._init_experts(gen, e, d, f, torch.float32),
         "w_out": TMO._init_experts(gen, e, f, d, torch.float32)}
    if gated:
        p["w_gate"] = TMO._init_experts(gen, e, d, f, torch.float32)
    return p


OCCUPIED = {"none": [], "one": [2], "all": [0, 1, 2, 3, 4]}


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("occupied", list(OCCUPIED))
def test_plain_experts_equal_the_batched_products_on_occupied_experts(occupied, gated):
    """The kernel's plain version (and the public wrapper on a CPU tensor)
    against ``_expert_ffn`` over five experts of three rows: the same on
    each expert whose count is above 0, whatever the count, and exact zeros
    on the others; SwiGLU and tanh-GELU experts."""
    e, r, d, f = 5, 3, 32, 48
    p = _expert_params(e, d, f, gated, seed=11)
    x = torch.randn(e, r, d, generator=torch.Generator().manual_seed(12))
    counts = torch.zeros(e, dtype=torch.int32)
    counts[OCCUPIED[occupied]] = torch.arange(1, len(OCCUPIED[occupied]) + 1, dtype=torch.int32)
    got = KX.moe_experts_plain(x, counts, p["w_in"], p.get("w_gate"), p["w_out"])
    assert torch.equal(KO.moe_experts(x, counts, p["w_in"], p.get("w_gate"), p["w_out"]), got)
    busy = counts > 0
    torch.testing.assert_close(got[busy], TMO._expert_ffn(p, x)[busy], **F32)
    assert torch.equal(got[~busy], torch.zeros_like(got[~busy]))


def test_moe_experts_refuses_what_the_kernel_cannot_take():
    p = _expert_params(4, 32, 48, True, seed=13)
    args = (p["w_in"], p["w_gate"], p["w_out"])
    x, counts = torch.zeros(4, 2, 32), torch.ones(4, dtype=torch.int32)
    for bad, what in ((torch.zeros(4, KX.ROW_LIMIT + 1, 32), "rows an expert"),
                      (x, "int32")):
        with pytest.raises(ValueError, match=what):
            KO.moe_experts(bad, counts if what != "int32" else counts.long(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        KO.moe_experts(torch.zeros(4, 32, 2).transpose(1, 2), counts, *args)


@pytest.mark.parametrize("k,n", [(4096, 14336), (14336, 4096), (7168, 2048), (2048, 7168),
                                 (2048, 1408), (1408, 2048), (32, 48), (200, 8)])
def test_split_plan_covers_the_depth_in_whole_stages(k, n):
    """jamba's, Kimi's and qwen2-moe's up and down products and two small
    ones: splits of a whole number of 64-row stages, none empty, together
    covering the depth; a grid of at most TARGET_BLOCKS blocks (one wave)
    and at least half as many where the widths allow."""
    splits, kc = KX.split_plan(k, n)
    assert kc % KX.BK == 0 and (splits - 1) * kc < k <= splits * kc
    tiles = -(-n // KX.BN)
    assert min(KX.TARGET_BLOCKS // 2, tiles * -(-k // KX.BK)) <= splits * tiles <= max(
        KX.TARGET_BLOCKS, tiles)


# name: (moe config, gated, B, a router that sends every token to experts 0 and 1)
DECODE_CASES = {
    "jamba_b8": (dict(n_experts=16, top_k=2, d_ff_expert=64, capacity_factor=1.25), True, 8,
                 False),
    "jamba_b1": (dict(n_experts=16, top_k=2, d_ff_expert=64, capacity_factor=1.25), True, 1,
                 False),
    "overflow": (dict(n_experts=4, top_k=2, d_ff_expert=64, capacity_factor=1.25), True, 8,
                 True),
    "shared_gelu": (dict(QWEN, n_experts=16), False, 4, False),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_moe_equals_the_all_experts_path(case):
    """A decode step's MoE layer (S 1, einsum dispatch, capacity 1 or 2 an
    expert, or 6 under 16 pairs where the router sends every token to
    experts 0 and 1, so R5 drops four) through ``moe_experts`` against the
    products over every expert: the same output, the same drops; the
    counters read the experts given and those holding a kept pair."""
    kw, gated, b, forced = DECODE_CASES[case]
    _, tm = _mcfgs(**kw)
    _, tp = _params(JMoE(**kw), gated, seed=14)
    gen = torch.Generator().manual_seed(15)
    x = torch.rand((b, 1, D), generator=gen) + 0.1 if forced else torch.randn((b, 1, D),
                                                                            generator=gen)
    if forced:
        tp = dict(tp, router=torch.tensor([[1.0, 0.5, -1.0, -1.0]]).repeat(D, 1))
    cap = TMO._capacity(b, tm)
    assert cap <= KX.ROW_LIMIT
    _, top_i, _ = TMO._route(tp, x.reshape(1, b, D), tm)
    pos = TMO._positions_in_expert_grouped(top_i, tm, cap)
    kept = set(top_i[pos < cap].tolist())
    with tracing.recording() as rec:
        y, aux = TMO.moe_apply(tp, x, tm)
    assert rec.counters["moe.experts"] == tm.n_experts
    assert rec.counters["moe.experts_read"] == len(kept) < tm.n_experts
    assert rec.counters["moe.dropped"] == int((pos >= cap).sum()) == (4 if forced else
                                                                      rec.counters["moe.dropped"])
    with tracing.recording() as rec0:
        y0, aux0 = TMO.moe_apply(tp, x, tm, expert_impl="naive")
    assert "moe.experts" not in rec0.counters
    assert rec0.counters["moe.dropped"] == rec.counters["moe.dropped"]
    torch.testing.assert_close(y, y0, **F32)
    assert torch.equal(aux, aux0)


def test_static_held_decode_equals_the_all_experts_path():
    """Sigmoid routing over 4 held experts of 16 (top 4, a shared expert),
    a decode step of 4 rows: each held expert gets its routed rows only and
    an expert with none is not read; the output equals every held expert
    over every row weighed by zero where not routed, and the sorted
    prefill dispatch; the counters read the 4 experts given and those
    routed to."""
    mcfg = TMoE(n_experts=16, top_k=4, d_ff_expert=24, n_shared_experts=1, d_ff_shared=24,
                router="sigmoid", routed_scale=2.5, ep_size=4)
    gen = torch.Generator().manual_seed(16)
    p = TMO.init_moe(gen, D, mcfg, True, torch.float32)
    p["bias"] = torch.randn(16, generator=gen) * 0.1
    x = torch.randn(4, 1, D, generator=gen)
    _, top_i = TMO._route_sigmoid(p, x.reshape(4, D), mcfg)
    routed = set(top_i[top_i < 4].tolist())
    assert 0 < len(routed) < 4
    with tracing.recording() as rec:
        y, _ = TMO.moe_apply(p, x, mcfg, static=True)
    assert (rec.counters["moe.experts"], rec.counters["moe.experts_read"]) == (4, len(routed))
    torch.testing.assert_close(y, TMO.moe_apply(p, x, mcfg, static=False)[0], **F32)
    with tracing.recording() as rec0:
        y0, _ = TMO.moe_apply(p, x, mcfg, static=True, expert_impl="naive")
    assert "moe.experts" not in rec0.counters
    torch.testing.assert_close(y, y0, **F32)


def test_training_and_prefill_shapes_keep_the_batched_products():
    """Rows past the limit, or inputs that need a gradient, take the
    products over every expert: ``moe.experts`` is not counted."""
    kw = dict(n_experts=4, top_k=2, d_ff_expert=64, capacity_factor=1.25)
    _, tm = _mcfgs(**kw)
    _, tp = _params(JMoE(**kw), True, seed=17)
    gen = torch.Generator().manual_seed(18)
    assert TMO._capacity(64, tm) > KX.ROW_LIMIT
    for x in (torch.randn(4, 16, D, generator=gen),
              torch.randn(2, 1, D, generator=gen).requires_grad_()):
        with tracing.recording() as rec:
            y, _ = TMO.moe_apply(tp, x, tm)
        assert "moe.experts" not in rec.counters
    y.sum().backward()
    assert x.grad is not None


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "kimi-k2-instruct"])
def test_the_stack_impl_picks_the_expert_products_of_a_decode_step(arch):
    """The stack's ``impl`` reaches the MoE layers of a reduced decode step:
    ``kernel`` gives their experts to ``moe_experts``, ``naive`` runs the
    products over every expert (the reference the kernel path is held to),
    and both give the same logits."""
    from repro_torch.models import model as TM
    cfg = TC.get_config(arch, reduced=True)
    params = TM.init(cfg, seed=0, device="cpu")
    s = 6
    toks = torch.from_numpy(np.random.default_rng(19).integers(0, cfg.vocab, (2, s + 1)))
    with torch.inference_mode():
        _, caches, _ = TM.prefill(params, cfg, {"tokens": toks[:, :s]}, capacity=s + 1,
                                  impl="naive")
        out = {}
        for impl in ("kernel", "naive"):
            step_caches = [{k: t.clone() for k, t in c.items()} for c in caches]
            with tracing.recording() as rec:
                lg, _ = TM.decode_step(params, cfg, step_caches, s, toks[:, s:], impl=impl)
            out[impl] = lg, rec.counters
    n_moe = sum("moe" in lay for lay in params["stack"])
    assert n_moe > 0
    assert out["kernel"][1]["moe.experts"] == n_moe * cfg.moe.n_held
    assert "moe.experts" not in out["naive"][1]
    torch.testing.assert_close(out["kernel"][0], out["naive"][0], **F32)
