"""Kimi-K2-Instruct in the port: latent attention (MLA) with YaRN, the
leading dense layer, sigmoid noaux_tc routing over held experts, dropless,
and K1 at latent attention's head dims, against the benchmark's plain
float32 reference (``bench/reference/mla.py``) and values worked out here.
CPU, f32: tolerance 2e-4, the reference's for f32 paths."""
import dataclasses
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bench import spec, weights                                      # noqa: E402
from bench.layouts import mla as LAY                                 # noqa: E402
from bench.reference import mla as REF                               # noqa: E402
from repro_torch import configs                                      # noqa: E402
from repro_torch import tracing                                      # noqa: E402
from repro_torch.kernels import flash_attention as K1                # noqa: E402
from repro_torch.models import layers as L                           # noqa: E402
from repro_torch.models import mla as MLA                            # noqa: E402
from repro_torch.models import model as M                            # noqa: E402
from repro_torch.models import moe as MO                             # noqa: E402
from repro_torch.serving.engine import StageServer                   # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
# 192 ** -0.5 * (0.1 * ln 32 + 1) ** 2, worked out by hand
KIMI_SCALE = 0.0721687836 * 1.3465735903 ** 2


def _stage():
    return spec.config("kimi-k2-s0")["stages"][0]


@pytest.fixture(scope="module")
def tiny():
    """The tiny copy of the Kimi cell's stage: weights in the benchmark's
    names (f32, seeded), the program's tree and config over them."""
    st = LAY.tiny(_stage())
    w = weights.make_weights(st, 29, 0, "cpu", dtype=torch.float32)
    return st, w, LAY.to_port(w, st), LAY.port_config(st, dtype=torch.float32)


def test_yarn_frequencies_and_scale_worked_out_by_hand():
    """Kimi's keys (rope dim 64, theta 50000, factor 32 over 4096, beta 1
    and 1): the correction dim 64 ln(4096 / 2 pi) / (2 ln 50000) = 19.16,
    so pairs 0-19 keep theta^(-2i/64) and pairs 20-31 are divided by 32;
    the cos/sin factor is 1 and the softmax scale 0.13086."""
    cfg = configs.get_config("kimi-k2-instruct")
    corr = 64 * math.log(4096 / (2 * math.pi)) / (2 * math.log(50000))
    assert 19 < corr < 20
    want = [50000 ** (-2 * i / 64) / (32 if i >= 20 else 1) for i in range(32)]
    got = L.yarn_freqs(64, cfg.rope_theta, cfg.rope_scaling)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(REF.inv_freq(_stage(), "cpu").numpy(), want, rtol=1e-6)
    assert MLA.softmax_scale(cfg) == pytest.approx(KIMI_SCALE, rel=1e-7)
    assert MLA.softmax_scale(cfg) == pytest.approx(0.13086, abs=1e-5)
    assert REF.softmax_scale(_stage()) == pytest.approx(KIMI_SCALE, rel=1e-7)
    x = torch.randn(1, 5, 2, 64)
    pos = torch.arange(5)[None]
    assert torch.equal(MLA._rope(x, pos, cfg), L.apply_rope(x, pos, cfg.rope_theta, freqs=got))


def test_configs_count_the_published_model():
    """About 1.03 T parameters and 32.9 B active, counted with MLA, the
    dense layer 0, the selection bias and untied embeddings; the cell's
    card holds 19.745 B."""
    cfg = configs.get_config("kimi-k2-instruct")
    assert cfg.n_params() == 1_026_408_232_448
    assert cfg.n_active_params() == 32_861_500_928
    assert cfg.mla_params() == 101_122_048 + 1536 + 512
    assert [cfg.is_moe_layer(i) for i in (0, 1, 60)] == [False, True, True]
    assert "kimi-k2-instruct" not in configs.ARCH_IDS
    st = _stage()
    card = LAY.port_config(st)
    n = sum(int(np.prod(s)) for _, s, _, _ in LAY.shapes(st))
    assert n == 19_745_354_368
    assert card.n_params() == n                       # tied: one embedding
    assert (card.moe.first_held, card.moe.n_held, card.moe.n_experts) == (0, 24, 384)


def test_the_cell_config_states_every_key_at_its_top_and_in_its_stage():
    """The configuration file holds the published keys at its top level
    (the catalog's form) and in its stage (what the harness reads): the
    same values, the cut ones listed in ``reduced``."""
    top = spec.config("kimi-k2-s0")
    st = top["stages"][0]
    shared = set(top) & set(st)
    assert {"hidden_size", "kv_lora_rank", "rope_scaling", "n_routed_experts"} <= shared
    assert {k: top[k] for k in shared if k != "source"} == \
        {k: st[k] for k in shared if k != "source"}
    bench = spec.benchmark()
    (entry,) = [c for c in bench["configs"] if c["name"] == "kimi-k2-s0"]
    assert entry["reduced"] == top["reduced"] == ["num_hidden_layers", "n_routed_experts"]
    assert (st["num_hidden_layers"], st["published_num_hidden_layers"]) == (16, 61)
    assert (st["n_routed_experts"], st["published_n_routed_experts"]) == (24, 384)
    assert json.dumps(st["rope_scaling"], sort_keys=True) == json.dumps(
        {"beta_fast": 1, "beta_slow": 1, "factor": 32, "mscale": 1, "mscale_all_dim": 1,
         "original_max_position_embeddings": 4096, "type": "yarn"}, sort_keys=True)


def test_prefill_then_decode_match_the_reference(tiny):
    """The tiny stage (dense layer 0, four MoE layers of 4 held experts of
    the router's 64, top 8) through ``M.prefill`` and three absorbed
    ``decode_step``s over the latent cache: each position's logits against
    the reference's full forward."""
    st, w, params, cfg = tiny
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, st["vocab_size"], (2, 19)))
    s, steps = 16, 3
    with torch.inference_mode():
        want = torch.cat(REF.forward(w, st, [ids], s, steps + 1))
        hl, caches, _ = M.prefill(params, cfg, {"tokens": ids[:, :s]}, capacity=s + steps)
        got = [hl @ params["embed"].T]
        for i in range(steps):
            lg, caches = M.decode_step(params, cfg, caches, s + i, ids[:, s + i:s + i + 1])
            got.append(lg)
    torch.testing.assert_close(torch.stack(got, 1), want, **TOL)


def test_absorbed_decode_matches_the_non_absorbed_forward(tiny):
    """The absorbed decode step (queries taken into the latent space) and
    the non-absorbed full forward give the same logits."""
    st, w, params, cfg = tiny
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, st["vocab_size"], (3, 12)))
    with torch.inference_mode():
        h, _ = M.forward(params, cfg, {"tokens": ids})
        full = M.logits(params, cfg, h)
        _, caches, _ = M.prefill(params, cfg, {"tokens": ids[:, :8]}, capacity=12)
        for i in range(8, 12):
            lg, caches = M.decode_step(params, cfg, caches, torch.tensor(i), ids[:, i:i + 1])
            torch.testing.assert_close(lg, full[:, i], **TOL)


def test_mla_prefill_kernel_and_naive_paths_agree(tiny):
    """The prefill's attention through K1's plain version at (192, 128)
    with YaRN's scale, and through the naive path."""
    st, w, params, cfg = tiny
    x = torch.randn(2, 20, cfg.d_model)
    pos = torch.arange(20)[None].expand(2, 20)
    a, ca = MLA.prefill(params["stack"][1]["attn"], x, pos, cfg, capacity=24, impl="kernel")
    b, cb = MLA.prefill(params["stack"][1]["attn"], x, pos, cfg, capacity=24, impl="naive")
    torch.testing.assert_close(a, b, **TOL)
    assert torch.equal(ca["c_kv"], cb["c_kv"]) and ca["c_kv"].shape == (2, 24, 64)
    assert not ca["c_kv"][:, 20:].any() and ca["k_pe"].shape == (2, 24, 64)


@pytest.mark.parametrize("b,sq,sk,h,kv,causal,window", [
    (2, 33, 33, 4, 4, True, None), (1, 40, 70, 4, 2, True, 16), (2, 17, 30, 2, 2, False, None)])
def test_flash_plain_at_mla_head_dims_matches_naive(b, sq, sk, h, kv, causal, window):
    """K1's plain version with v narrower than q and k (192 / 128) and a
    scale, against ``attention_naive``."""
    g = torch.Generator().manual_seed(sq)
    q = torch.randn(b, sq, h, 192, generator=g)
    k, v = torch.randn(b, sk, kv, 192, generator=g), torch.randn(b, sk, kv, 128, generator=g)
    got = K1.flash_attention(q, k, v, causal=causal, window=window, scale=KIMI_SCALE)
    want = L.attention_naive(q, k, v, torch.arange(sq)[None], torch.arange(sk)[None],
                             window, causal, KIMI_SCALE)
    assert got.shape == (b, sq, h, 128)
    torch.testing.assert_close(got, want, **TOL)
    with pytest.raises(ValueError, match="head dims"):
        K1.flash_attention(q[..., :96], k[..., :96], v[..., :64])


def _router(e=16, k=4, **kw):
    """The reduced Kimi's MoE config with ``e`` experts, all held, top ``k``."""
    return dataclasses.replace(configs.get_config("kimi-k2-instruct", reduced=True).moe,
                               n_experts=e, top_k=k, ep_size=1, **kw)


def test_sigmoid_routing_selects_by_the_biased_score_and_weighs_by_the_unbiased():
    """Selection by sigmoid score + bias, weights the chosen unbiased scores
    over their sum times 2.827; equal selection scores go to the lower
    expert."""
    mcfg = _router(e=6, k=2)
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0, 0.5, 0.5]])
    params = {"router": torch.eye(6), "bias": torch.tensor([0.0, 0.0, 0.9, 0.0, 0.0, 0.0])}
    top_w, top_i = MO._route_sigmoid(params, logits, mcfg)
    sig = torch.sigmoid(logits[0])
    # biased: expert 2 (0.5 + 0.9) beats expert 1 (0.731)
    assert top_i.tolist() == [[2, 0]]
    want = torch.stack([sig[2], sig[0]]) / (sig[2] + sig[0]) * 2.827
    torch.testing.assert_close(top_w[0], want)
    params["bias"] = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    logits = torch.tensor([[0.5, 0.3, 0.3, 0.3, 0.1, 0.5]])
    _, top_i = MO._route_sigmoid(params, logits, mcfg)
    assert top_i.tolist() == [[0, 5]]                      # a tie: the lower index first
    _, top_i = MO._route_sigmoid(params, logits, _router(e=6, k=3))
    assert top_i.tolist() == [[0, 5, 1]]
    ref_w, ref_i = REF.route(logits, {"x.gate": torch.eye(6), "x.gate.e_score_correction_bias":
                                      params["bias"]}, "x.",
                             {"num_experts_per_tok": 3, "routed_scaling_factor": 2.827}, "f32")
    assert ref_i.tolist() == [[0, 5, 1]]


def _moe_params(mcfg, d, seed):
    gen = torch.Generator().manual_seed(seed)
    p = MO.init_moe(gen, d, mcfg, True, torch.float32)
    p["bias"] = torch.randn(mcfg.n_experts, generator=gen) * 0.1
    return p


def _share(p, mcfg, rank, size):
    n = mcfg.n_experts // size
    q = dict(p, **{k: p[k][rank * n:(rank + 1) * n] for k in ("w_in", "w_gate", "w_out")})
    return q, dataclasses.replace(mcfg, ep_rank=rank, ep_size=size)


@pytest.mark.parametrize("size", [4, 16])
def test_expert_parallel_shares_sum_to_the_uncut_layer(size):
    """The guide's share test: the parts that the ``size`` ranks' shares give,
    with the shared expert (which every rank computes alike) counted once,
    add up to the uncut layer's output, in prefill's sorted dispatch and in
    decode's static one."""
    d, mcfg = 32, _router(e=16, k=4, d_ff_expert=24, d_ff_shared=24)
    p = _moe_params(mcfg, d, 7)
    x = torch.randn(3, 10, d, generator=torch.Generator().manual_seed(8))
    shared = L.mlp(p["shared"], x)
    for static in (False, True):
        whole, aux = MO.moe_apply(p, x, mcfg, static=static)
        assert aux is None
        parts = sum(MO.moe_apply(q, x, c, static=static)[0] - shared
                    for q, c in (_share(p, mcfg, r, size) for r in range(size)))
        torch.testing.assert_close(parts + shared, whole, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(MO.moe_apply(p, x, mcfg, static=True)[0],
                               MO.moe_apply(p, x, mcfg)[0], **TOL)


def test_held_experts_are_counted_and_none_dropped(tiny):
    """``moe.pairs`` counts every routed pair, ``moe.held`` those routed to a
    held expert (4 of 64 here: about 1/16); the reference, computing the
    held pairs only, agrees with the layer."""
    st, w, params, cfg = tiny
    lay = params["stack"][1]["moe"]
    x = torch.randn(1, 64, cfg.d_model, generator=torch.Generator().manual_seed(9))
    with tracing.recording() as rec:
        y, _ = MO.moe_apply(lay, x, cfg.moe)
    assert rec.counters["moe.pairs"] == 64 * 8
    top_w, top_i = MO._route_sigmoid(lay, x[0], cfg.moe)
    assert rec.counters["moe.held"] == int((top_i < 4).sum()) > 0
    want = REF.moe(x[0], w, "layers.1.mlp.", st, "f32")
    torch.testing.assert_close(y[0], want, **TOL)


def test_a_stage_server_serves_the_tiny_stage(tiny):
    """StageServer.process on the CPU: eager prefill through K1's plain
    version, eager absorbed decode steps, the tokens the eager loop
    chooses."""
    st, w, params, cfg = tiny
    srv = StageServer("kimi", [("kimi", cfg, 0.0)], gen_tokens=4, max_ctx=20,
                      params_by_variant={"kimi": params}, device="cpu")
    prompt = np.random.default_rng(5).integers(0, st["vocab_size"], (2, 12)).astype(np.int32)
    with tracing.recording() as rec:
        got, _ = srv.process(prompt)
    assert got.shape == (2, 4) and rec.counters["decode.eager"] == 4
    names = {s.name for s in rec.spans}
    assert {"mla.down", "mla.up", "mla.attend", "mla.out", "moe.route"} <= names
    ids = torch.from_numpy(np.concatenate([prompt, got[:, :-1]], 1).astype(np.int64))
    with torch.inference_mode():
        want = torch.cat(REF.forward(w, st, [ids], 12, 4)).argmax(-1)
    np.testing.assert_array_equal(got, want.numpy())


def test_the_reference_converter_refuses_latent_attention():
    from repro_torch.models import convert
    cfg = configs.get_config("kimi-k2-instruct", reduced=True)
    with pytest.raises(NotImplementedError, match="latent attention"):
        convert.param_shapes(M.init(cfg, seed=0, device="cpu"), cfg)
