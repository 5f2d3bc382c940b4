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
from repro_torch.configs.base import MoEConfig as TMoE
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
