"""The enc-dec family (whisper) in repro_torch against repro on the
reference's own parameters (``repro.models.model.init``, converted through
numpy).

Reduced whisper-medium (2 encoder + 2 decoder layers, d 256, 4 heads of 64,
48 frames) takes the same tokens and frames in both packages: the encoder
alone, ``forward``, ``prefill`` (its last hidden state and every layer's
``k``, ``v``, ``xk`` and ``xv`` caches) and three ``decode_step``s, with the
port's ``impl="kernel"`` (each kernel's plain version on the CPU) and
``impl="naive"``.  The reference runs its naive attention everywhere
(ROADMAP R3); its ``decode_step`` has no ``impl``.

Tolerances are the reference's: 2e-4 for f32; bf16 is held on greedy
tokens where the top-2 margin exceeds 2e-2 (ROADMAP P1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import stack as JS
from repro_torch import configs as TC
from repro_torch.kernels import ops
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

F32 = dict(atol=2e-4, rtol=2e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
B, PROMPT, STEPS = 2, 10, 3
ARCH = "whisper-medium"


def _configs(dtype):
    jcfg = JC.get_config(ARCH, reduced=True)
    tcfg = TC.get_config(ARCH, reduced=True)
    if dtype == "bfloat16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    return jcfg, tcfg


def _np(x):
    """A float32 numpy copy: the port updates its caches in place."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy().copy()
    return np.asarray(x, np.float32)


def _jax_layer(tree, jcfg, i):
    """Decoder layer i of a stacked reference pytree (params or caches)."""
    pl = JS.plan(jcfg, cross=True)
    if i < pl.n_rep * pl.period:
        return jax.tree.map(lambda a: a[i // pl.period], tree["blocks"][i % pl.period])
    return tree["rem"][i - pl.n_rep * pl.period]


def _run(dtype):
    jcfg, tcfg = _configs(dtype)
    rng = np.random.default_rng(0)
    total = PROMPT + STEPS
    toks = rng.integers(0, jcfg.vocab, (B, total)).astype(np.int32)
    frames = rng.standard_normal((B, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    jparams = jax.jit(JM.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")

    def jbatch(t):
        return {"tokens": jnp.asarray(t), "frames": jnp.asarray(frames)}

    def tbatch(t):
        return {"tokens": torch.from_numpy(t.copy()), "frames": torch.from_numpy(frames)}

    out = {"jcfg": jcfg, "tcfg": tcfg, "tparams": tparams, "frames": frames, "toks": toks}
    enc = jax.jit(lambda p, f: JM._encode(p, jcfg, f, "naive"))(jparams, jnp.asarray(frames))
    out["encode"] = _np(enc)

    @jax.jit
    def jfwd(p, b):
        h, _ = JM.forward(p, jcfg, b, impl="naive")
        return h, JM.logits(p, jcfg, h)

    out["forward"] = tuple(_np(a) for a in jfwd(jparams, jbatch(toks)))
    jpre = jax.jit(lambda p, b: JM.prefill(p, jcfg, b, impl="naive", capacity=total)[:2])
    jdec = jax.jit(lambda p, c, n, t: JM.decode_step(p, jcfg, c, n, t))
    hl, jcaches = jpre(jparams, jbatch(toks[:, :PROMPT]))
    out["prefill"] = _np(hl)
    out["prefill_caches"] = [jax.tree.map(_np, _jax_layer(jcaches, jcfg, i))
                             for i in range(jcfg.n_layers)]
    decode = []
    for t in range(PROMPT, total):
        lg, jcaches = jdec(jparams, jcaches, jnp.int32(t), jnp.asarray(toks[:, t:t + 1]))
        decode.append(_np(lg))
    out["decode"] = np.stack(decode)
    out["decode_caches"] = [jax.tree.map(_np, _jax_layer(jcaches, jcfg, i))
                            for i in range(jcfg.n_layers)]

    with torch.inference_mode():
        out["encode_port"] = _np(TM.encode(tparams, tcfg, torch.from_numpy(frames)))
        th, aux = TM.forward(tparams, tcfg, tbatch(toks))
        out["forward_port"] = (_np(th), _np(TM.logits(tparams, tcfg, th)))
        assert float(aux) == 0.0
        for impl in ("kernel", "naive"):
            thl, tcaches, s = TM.prefill(tparams, tcfg, tbatch(toks[:, :PROMPT]), impl=impl,
                                         capacity=total)
            assert s == PROMPT
            out[f"prefill_port_{impl}"] = _np(thl)
            out[f"prefill_caches_port_{impl}"] = [{k: _np(v) for k, v in c.items()}
                                                  for c in tcaches]
            decode = []
            for t in range(PROMPT, total):
                lg, tcaches = TM.decode_step(tparams, tcfg, tcaches, t,
                                             torch.from_numpy(toks[:, t:t + 1].copy()),
                                             impl=impl)
                decode.append(_np(lg))
            out[f"decode_port_{impl}"] = np.stack(decode)
            out[f"decode_caches_port_{impl}"] = [{k: _np(v) for k, v in c.items()}
                                                 for c in tcaches]
    return out


@pytest.fixture(scope="module")
def f32():
    return _run("float32")


@pytest.fixture(scope="module")
def bf16():
    return _run("bfloat16")


def test_encoder_matches_reference(f32):
    assert f32["encode_port"].shape == (B, f32["jcfg"].encoder_seq, f32["jcfg"].d_model)
    np.testing.assert_allclose(f32["encode_port"], f32["encode"], **F32)


def test_forward_hidden_and_logits(f32):
    for got, want in zip(f32["forward_port"], f32["forward"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("impl", ["kernel", "naive"])
def test_prefill_hidden_and_caches(f32, impl):
    np.testing.assert_allclose(f32[f"prefill_port_{impl}"], f32["prefill"], **F32)
    cfg = f32["jcfg"]
    for got, want in zip(f32[f"prefill_caches_port_{impl}"], f32["prefill_caches"]):
        assert sorted(got) == sorted(want) == ["k", "v", "xk", "xv"]
        assert got["xk"].shape == (B, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim_)
        for key in want:
            assert got[key].shape == want[key].shape, key
            np.testing.assert_allclose(got[key], want[key], **F32)


@pytest.mark.parametrize("impl", ["kernel", "naive"])
def test_decode_logits_and_caches(f32, impl):
    got = f32[f"decode_port_{impl}"]
    assert got.shape == (STEPS, B, f32["jcfg"].vocab)
    np.testing.assert_allclose(got, f32["decode"], **F32)
    for layer, (c, want) in enumerate(zip(f32[f"decode_caches_port_{impl}"],
                                          f32["decode_caches"])):
        for key in want:
            np.testing.assert_allclose(c[key], want[key], **F32)
        # decode reads the cross caches and leaves them as prefill wrote them
        for key in ("xk", "xv"):
            np.testing.assert_array_equal(
                c[key], f32[f"prefill_caches_port_{impl}"][layer][key])


def _top2_margin(lg):
    top = np.sort(lg, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


@pytest.mark.parametrize("impl", ["kernel", "naive"])
def test_bf16_greedy_tokens_agree_where_the_margin_allows(bf16, impl):
    want = np.concatenate([bf16["forward"][1], bf16["decode"].transpose(1, 0, 2)], axis=1)
    got = np.concatenate([bf16["forward_port"][1],
                          bf16[f"decode_port_{impl}"].transpose(1, 0, 2)], axis=1)
    clear = _top2_margin(want) > BF16["atol"]
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def test_cross_attention_block_matches_reference():
    """The block alone: the reference's ``attn_block`` with ``kv_override``
    (no RoPE on either side, no mask), at Sq 5 over Sk 17."""
    rng = np.random.default_rng(3)
    d, h, hd = 64, 4, 32
    arrs = {k: (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
            for k, shape in (("wq", (d, h, hd)), ("wk", (d, h, hd)), ("wv", (d, h, hd)),
                             ("wo", (h, hd, d)))}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    enc = rng.standard_normal((2, 17, d)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(5)[None], (2, 5))
    want, (wk, wv) = JL.attn_block({k: jnp.asarray(a) for k, a in arrs.items()},
                                   jnp.asarray(x), pos, 10_000.0, impl="naive",
                                   kv_override=jnp.asarray(enc))
    tp = {k: torch.from_numpy(a) for k, a in arrs.items()}
    for impl in ("kernel", "naive"):
        got, (gk, gv) = TL.cross_attn_block(tp, torch.from_numpy(x), torch.from_numpy(enc),
                                            impl=impl)
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        np.testing.assert_allclose(_np(gk), _np(wk), **F32)
        np.testing.assert_allclose(_np(gv), _np(wv), **F32)


class _Calls:
    """Records the shapes and flags of every call of ops.flash_attention and
    ops.decode_attention while active."""

    def __init__(self, monkeypatch):
        self.flash, self.decode = [], []
        flash, decode = ops.flash_attention, ops.decode_attention

        def rec_flash(q, k, v, *a, causal=True, window=None, **kw):
            self.flash.append((q.shape[1], k.shape[1], causal))
            return flash(q, k, v, *a, causal=causal, window=window, **kw)

        def rec_decode(q, kc, vc, lengths, **kw):
            self.decode.append((kc.shape[1], lengths.tolist()))
            return decode(q, kc, vc, lengths, **kw)
        monkeypatch.setattr(ops, "flash_attention", rec_flash)
        monkeypatch.setattr(ops, "decode_attention", rec_decode)


def test_kernels_carry_every_attention_of_the_kernel_path(f32, monkeypatch):
    """With impl="kernel": K1 non-causal over the frames in every encoder
    layer, causal over the prompt and non-causal with Sq != Sk (the prompt
    over the frames) in every decoder layer; K2 over the self cache and over
    the frames (lengths F) in every decoder layer and step."""
    cfg, params = f32["tcfg"], f32["tparams"]
    f, n = cfg.encoder_seq, cfg.n_layers
    calls = _Calls(monkeypatch)
    batch = {"tokens": torch.from_numpy(f32["toks"][:, :PROMPT].copy()),
             "frames": torch.from_numpy(f32["frames"])}
    with torch.inference_mode():
        _, caches, _ = TM.prefill(params, cfg, batch, capacity=PROMPT + 1)
        TM.decode_step(params, cfg, caches, PROMPT, batch["tokens"][:, :1])
    assert sorted(calls.flash) == sorted([(f, f, False)] * cfg.n_encoder_layers
                                         + [(PROMPT, PROMPT, True), (PROMPT, f, False)] * n)
    assert sorted(calls.decode) == sorted([(PROMPT + 1, [PROMPT + 1] * B), (f, [f] * B)] * n)
    calls.flash.clear()
    with torch.inference_mode():
        TM.prefill(params, cfg, batch, impl="naive")
    assert calls.flash == []


def test_prefill_and_forward_without_frames_raise(f32):
    cfg, params = f32["tcfg"], f32["tparams"]
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64)}
    with pytest.raises(KeyError, match="frames"):
        TM.prefill(params, cfg, batch)
    with pytest.raises(KeyError, match="frames"):
        TM.forward(params, cfg, batch)


def test_init_cache_sizes_the_cross_caches_by_the_encoder_length():
    cfg = TC.get_config(ARCH, reduced=True)
    caches = TM.init_cache(cfg, 3, 20, device="cpu")
    assert len(caches) == cfg.n_layers
    for c in caches:
        assert c["k"].shape == (3, 20, cfg.n_kv_heads, cfg.head_dim_)
        assert c["xk"].shape == c["xv"].shape == (3, cfg.encoder_seq, cfg.n_kv_heads,
                                                  cfg.head_dim_)
