"""repro_torch.training (AdamW, data, loss and train step, checkpoints), the
chunked attention it trains through and the training launcher, against
repro.training and repro.models.layers on the same inputs.

Gradients are held within 2e-4 of the reference's, relative to each leaf's
largest.  AdamW is held on *identical* gradients (the same numpy arrays in
both packages) within 1e-6: its first step moves every element by about
``lr * sign(g)``, so params stepped on each framework's own gradients can
differ by ``2 * lr`` where a gradient near zero changes sign, and are not
compared.  ``global_norm`` sums the port's per-layer leaves in another
order than the reference's stacked ones, so the two agree within f32
rounding, not bit for bit.  The kernels have no backward: their wrappers
refuse inputs that require grad, on the CPU as on the card.
"""
import dataclasses
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import layers as JL
from repro.models import model as JM
from repro.training import checkpoint as JCK
from repro.training import data as JD
from repro.training import optim as JO
from repro.training import train as JT
from repro_torch import configs as TC
from repro_torch.examples import train_variant
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving.engine import StageServer
from repro_torch.training import checkpoint as TCK
from repro_torch.training import data as TD
from repro_torch.training import optim as TO
from repro_torch.training import train as TT

F32 = dict(atol=2e-4, rtol=2e-4)
GRAD_ARCHS = ("starcoder2-3b", "qwen2-moe-a2.7b", "mamba2-2.7b")


def _rng(seed):
    return np.random.default_rng(seed)


def _leaves_with_paths(tree):
    return [(jax.tree_util.keystr(k), np.asarray(v))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_grads(params, cfg, batch, **kw):
    leaves = TO.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, parts = TT.loss_fn(params, cfg, batch, **kw)
    flat = iter(torch.autograd.grad(loss, leaves, materialize_grads=True))
    for p in leaves:
        p.requires_grad_(False)
    parts = {k: v.detach() for k, v in parts.items()}
    return loss.detach(), parts, TO.tree_map(lambda _: next(flat), params)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 5, 10, 100])
def test_schedule_as_the_reference(step):
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    got = float(TO.schedule(TO.AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32)))
    want = float(JO.schedule(JO.AdamWConfig(**kw), jnp.int32(step)))
    assert got == want
    assert got == pytest.approx({0: 0.0, 5: 5e-4, 10: 1e-3, 100: 1e-4}[step], rel=0.01)


def test_adamw_config_defaults_are_the_reference():
    assert dataclasses.asdict(TO.AdamWConfig()) == dataclasses.asdict(JO.AdamWConfig())


@pytest.fixture(scope="module")
def adamw_case():
    """Reduced starcoder2-3b parameters in f32 and bf16, two sets of random
    gradients (numpy, the reference's stacked layout), and the reference's
    params and moments after two ``apply_updates`` on them."""
    out = {}
    for dt in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(JC.get_config("starcoder2-3b", reduced=True),
                                   dtype=getattr(jnp, dt))
        tcfg = dataclasses.replace(TC.get_config("starcoder2-3b", reduced=True),
                                   dtype=getattr(torch, dt))
        params = JM.init(jax.random.PRNGKey(1), jcfg)
        rng = _rng(2)
        grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.02).astype(p.dtype),
                              params) for _ in range(2)]
        ocfg = JO.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=0.5)
        p, state, norms = params, JO.init_state(params), []
        for g in grads:
            p, state, m = JO.apply_updates(p, g, state, ocfg)
            norms.append(float(m["grad_norm"]))
        out[dt] = dict(jcfg=jcfg, tcfg=tcfg, params=jax.tree.map(np.asarray, params),
                       grads=[jax.tree.map(np.asarray, g) for g in grads], want=p,
                       state=state, norms=norms, lr=float(m["lr"]))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_on_identical_gradients(adamw_case, dtype):
    c = adamw_case[dtype]
    tcfg = c["tcfg"]
    params = convert.params_from_jax(c["params"], tcfg, device="cpu")
    state = TO.init_state(params)
    ocfg = TO.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=0.5)
    norms = []
    for g in c["grads"]:
        grads = convert.params_from_jax(g, tcfg, device="cpu")
        params, state, m = TO.apply_updates(params, grads, state, ocfg,
                                            decay=TT.decay_mask(params, tcfg))
        norms.append(float(m["grad_norm"]))
    assert int(state["step"]) == 2 and state["step"].dtype == torch.int32
    assert float(m["lr"]) == pytest.approx(c["lr"], rel=1e-6)
    # the norms sum 1.6M squares in another order (see the module docstring)
    np.testing.assert_allclose(norms, c["norms"], rtol=1e-5)
    got = _leaves_with_paths(convert.params_to_jax(params, tcfg))
    want = _leaves_with_paths(c["want"])
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        if dtype == "bfloat16" and g.dtype.kind == "V":
            g = torch.from_numpy(g.view(np.int16)).view(torch.bfloat16).float().numpy()
            w = np.asarray(w, np.float32)
            # a result within 1e-6 of the reference's in f32 rounds to the same
            # bf16 value but where it lies within that of a rounding boundary
            assert np.mean(g != w) < 1e-3, key
            np.testing.assert_allclose(g, w, atol=1e-6 + 2 ** -7 * np.abs(w).max(), err_msg=key)
        else:
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=key)
    for name in ("mu", "nu"):
        got = _leaves_with_paths(convert.params_to_jax(
            state[name], dataclasses.replace(tcfg, dtype=torch.float32)))
        for (key, g), (_, w) in zip(got, _leaves_with_paths(c["state"][name])):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=(name, key))


def test_decay_mask_is_the_reference_choice():
    """The reference decays every leaf of a stacked block (its layer axis
    makes a norm scale 2-D) and judges the rest by their own ndim (R7)."""
    cfg = TC.get_config("gemma3-27b", reduced=True)
    params = TM.init(cfg, seed=0, device="cpu")
    mask = TT.decay_mask(params, cfg)
    stacked = convert.params_to_jax(params, cfg)
    want = [a.ndim >= 2 for _, a in _leaves_with_paths(stacked)]
    got = convert.params_to_jax(TO.tree_map(lambda m, p: torch.full(p.shape, float(m)),
                                            mask, params), cfg)
    got = [bool(a.reshape(-1)[0]) for _, a in _leaves_with_paths(got)]
    assert got == want and not all(want) and any(w for w in want)


def test_weight_decay_skips_vectors_and_moments_are_f32():
    p = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    g = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    state = TO.init_state(p)
    assert all(x.dtype == torch.float32 for x in TO.tree_leaves(state["mu"]))
    TO.apply_updates(p, g, state, TO.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.5))
    assert torch.all(p["b"] == 1.0) and torch.all(p["w"] < 1.0)


# ---------------------------------------------------------------------------
# cross-entropy
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ce_inputs():
    rng = _rng(0)
    b, s, d, v = 2, 64, 32, 128
    return (rng.standard_normal((b, s, d)).astype(np.float32),
            rng.standard_normal((v, d)).astype(np.float32),
            rng.integers(0, v, (b, s)).astype(np.int32))


@pytest.mark.parametrize("chunk", [16, 64, 10 ** 9])
def test_cross_entropy_chunked_and_direct_as_the_reference(ce_inputs, chunk):
    h, e, y = ce_inputs
    got = float(TT.cross_entropy(torch.from_numpy(h), torch.from_numpy(e),
                                 torch.from_numpy(y), chunk=chunk))
    want = float(JT.cross_entropy(jnp.asarray(h), jnp.asarray(e), jnp.asarray(y), chunk=chunk))
    assert got == pytest.approx(want, rel=1e-6)
    direct = float(TT.cross_entropy(torch.from_numpy(h), torch.from_numpy(e),
                                    torch.from_numpy(y), chunk=10 ** 9))
    assert abs(got - direct) < 1e-4


def test_cross_entropy_masks_labels(ce_inputs):
    h, e, y = ce_inputs
    y = y.copy()
    y[:, 1:] = -1
    got = float(TT.cross_entropy(torch.from_numpy(h), torch.from_numpy(e), torch.from_numpy(y)))
    want = float(JT.cross_entropy(jnp.asarray(h), jnp.asarray(e), jnp.asarray(y)))
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-6)
    none = TT.cross_entropy(torch.from_numpy(h), torch.from_numpy(e),
                            torch.full(y.shape, -1, dtype=torch.int32))
    assert float(none) == 0.0        # divisor max(count, 1)


# ---------------------------------------------------------------------------
# attention_chunked
# ---------------------------------------------------------------------------
# (Sq, query_chunk, window, causal): the KV slab (window 8, chunk 16 -> 128 of
# 256 keys), a window wider than the keys, causal and not, and the naive
# fallbacks (Sq % C != 0, Sq == C)
CHUNKED = [(256, 16, 8, True), (256, 32, 100, True), (256, 16, None, True),
           (256, 64, None, False), (40, 16, 8, True), (16, 16, None, True)]


def _chunked_inputs(sq, chunk):
    rng = _rng(sq + chunk)
    q, k, v = (rng.standard_normal((2, sq, h, 16)).astype(np.float32) for h in (4, 2, 2))
    pos = np.broadcast_to(np.arange(sq)[None], (2, sq)).astype(np.int32)
    w = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    return q, k, v, pos, w


@pytest.fixture(scope="module")
def chunked_ref():
    """The reference's ``attention_chunked`` and its gradients wrt q, k, v
    of ``sum(out * w)``, for every case of CHUNKED."""
    out = {}
    for sq, chunk, window, causal in CHUNKED:
        q, k, v, pos, w = _chunked_inputs(sq, chunk)

        def jfn(q, k, v):
            o = JL.attention_chunked(q, k, v, jnp.asarray(pos), jnp.asarray(pos), window,
                                     causal, query_chunk=chunk)
            return jnp.sum(o * w), o
        (_, o), grads = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        out[sq, chunk, window, causal] = np.asarray(o), [np.asarray(g) for g in grads]
    return out


@pytest.mark.parametrize("sq,chunk,window,causal", CHUNKED)
def test_attention_chunked_as_the_reference(chunked_ref, sq, chunk, window, causal):
    q, k, v, pos, w = _chunked_inputs(sq, chunk)
    want, jgrads = chunked_ref[sq, chunk, window, causal]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tpos = torch.from_numpy(np.ascontiguousarray(pos))
    got = TL.attention_chunked(tq, tk, tv, tpos, tpos, window, causal, query_chunk=chunk)
    tgrads = torch.autograd.grad((got * torch.from_numpy(w)).sum(), (tq, tk, tv))
    np.testing.assert_allclose(got.detach().numpy(), want, **F32)
    for g, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), jg, **F32)
    naive = TL.attention_naive(tq, tk, tv, tpos, tpos, window, causal)
    np.testing.assert_allclose(got.detach().numpy(), naive.detach().numpy(), **F32)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["starcoder2-3b", "phi-3-vision-4.2b", "whisper-medium"])
def test_synthetic_stream_batches_are_the_reference(arch):
    dc = dict(seq_len=24, batch_size=2, seed=3)
    want = JD.SyntheticStream(JC.get_config(arch, reduced=True), JD.DataConfig(**dc))
    got = TD.SyntheticStream(TC.get_config(arch, reduced=True), TD.DataConfig(**dc))
    for i in (0, 7):
        a, b = got.batch(i), want.batch(i)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_are_meta_tensors_of_the_reference_shapes(kind):
    for arch in ("whisper-medium", "phi-3-vision-4.2b"):
        got = TD.input_specs(TC.get_config(arch, reduced=True), 16, 2, kind)
        want = JD.input_specs(JC.get_config(arch, reduced=True), 16, 2, kind)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_grads():
    """The reference's loss, parts and gradients (impl="chunked") of one
    batch of each reduced f32 architecture, beside its params and batch."""
    out = {}
    for arch in GRAD_ARCHS:
        cfg = JC.get_config(arch, reduced=True)
        params = JM.init(jax.random.PRNGKey(0), cfg)
        batch = JD.SyntheticStream(cfg, JD.DataConfig(seq_len=32, batch_size=2)).batch(0)
        (loss, parts), grads = jax.value_and_grad(
            lambda p: JT.loss_fn(p, cfg, {k: jnp.asarray(v) for k, v in batch.items()},
                                 impl="chunked"), has_aux=True)(params)
        out[arch] = dict(params=jax.tree.map(np.asarray, params), batch=batch,
                         loss=float(loss), ce=float(parts["ce"]), aux=float(parts["aux"]),
                         grads=_leaves_with_paths(grads),
                         gnorm=float(JO.global_norm(grads)))
    return out


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_one_step_loss_and_gradients_as_the_reference(ref_grads, arch):
    r = ref_grads[arch]
    cfg = TC.get_config(arch, reduced=True)
    params = convert.params_from_jax(r["params"], cfg, device="cpu")
    batch = TD.to_device(r["batch"], "cpu")
    loss, parts, grads = _port_grads(params, cfg, batch, impl="chunked")
    assert float(loss) == pytest.approx(r["loss"], abs=2e-4)
    assert float(parts["ce"]) == pytest.approx(r["ce"], abs=2e-4)
    assert float(parts["aux"]) == pytest.approx(r["aux"], abs=2e-4)
    if arch.startswith("qwen2-moe"):
        assert r["aux"] > 0
    got = _leaves_with_paths(convert.params_to_jax(grads, cfg))
    assert [k for k, _ in got] == [k for k, _ in r["grads"]]
    for (key, g), (_, w) in zip(got, r["grads"]):
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) / scale < 2e-4, key
    # the train step: the same loss, the norm of the same gradients
    step = TT.make_train_step(cfg, TO.AdamWConfig(total_steps=10))
    params, state, m = step(params, TO.init_state(params), batch)
    assert float(m["loss"]) == pytest.approx(r["loss"], abs=2e-4)
    assert float(m["grad_norm"]) == pytest.approx(r["gnorm"], rel=1e-4)
    assert int(state["step"]) == 1
    assert not any(p.requires_grad for p in TO.tree_leaves(params))


def test_remat_gives_the_same_gradients():
    cfg = TC.get_config("starcoder2-3b", reduced=True)
    params = TM.init(cfg, seed=0, device="cpu")
    batch = TD.to_device(TD.SyntheticStream(cfg, TD.DataConfig(seq_len=8, batch_size=1))
                         .batch(0), "cpu")
    l1, _, g1 = _port_grads(params, cfg, batch, impl="naive")
    l2, _, g2 = _port_grads(params, cfg, batch, impl="naive", remat=True)
    assert float(l1) == float(l2)
    for a, b in zip(TO.tree_leaves(g1), TO.tree_leaves(g2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_loop_learns():
    cfg = TC.get_config("starcoder2-3b", reduced=True)
    stream = TD.SyntheticStream(cfg, TD.DataConfig(seq_len=32, batch_size=4))
    _, state, hist = TT.train_loop(cfg, stream, 12, log_every=11, verbose=False,
                                   ocfg=TO.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=12),
                                   device="cpu")
    assert [h["step"] for h in hist] == [0, 11] and int(state["step"]) == 12
    assert hist[-1]["loss"] < hist[0]["loss"]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["starcoder2-3b", "jamba-v0.1-52b", "whisper-medium"])
def test_checkpoints_load_across_packages(tmp_path, arch):
    jcfg, tcfg = JC.get_config(arch, reduced=True), TC.get_config(arch, reduced=True)
    params = JM.init(jax.random.PRNGKey(0), jcfg)
    JCK.save(str(tmp_path / "ref.npz"), params)
    port = TCK.load(str(tmp_path / "ref.npz"), tcfg, device="cpu")
    want = convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    for a, b in zip(TO.tree_leaves(port), TO.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    TCK.save(str(tmp_path / "port.npz"), port, tcfg)
    back = JCK.load(str(tmp_path / "port.npz"), jax.eval_shape(lambda: params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ref, ours = zipfile.ZipFile(tmp_path / "ref.npz"), zipfile.ZipFile(tmp_path / "port.npz")
    assert sorted(ref.namelist()) == sorted(ours.namelist())
    assert all(ref.read(n) == ours.read(n) for n in ref.namelist())


def test_bf16_checkpoint_by_raw_bits(tmp_path):
    """The reference writes bf16 leaves that np.load reads as raw ``V2``
    (ROADMAP R6); the port reads their bits, and writes the same members."""
    jcfg = dataclasses.replace(JC.get_config("mamba2-2.7b", reduced=True), dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(TC.get_config("mamba2-2.7b", reduced=True), dtype=torch.bfloat16)
    params = JM.init(jax.random.PRNGKey(4), jcfg)
    JCK.save(str(tmp_path / "ref.npz"), params)
    port = TCK.load(str(tmp_path / "ref.npz"), tcfg, device="cpu")
    want = convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    dtypes = set()
    for a, b in zip(TO.tree_leaves(port), TO.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
        dtypes.add(a.dtype)
    assert dtypes == {torch.bfloat16, torch.float32}     # A_log, D, dt_bias stay f32
    TCK.save(str(tmp_path / "port.npz"), port, tcfg)
    ref, ours = zipfile.ZipFile(tmp_path / "ref.npz"), zipfile.ZipFile(tmp_path / "port.npz")
    assert sorted(ref.namelist()) == sorted(ours.namelist())
    assert all(ref.read(n) == ours.read(n) for n in ref.namelist())


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------
def test_launch_train_main_on_the_cpu(tmp_path, capsys):
    path = str(tmp_path / "ckpt.npz")
    params, state, hist = launch_train.main(
        ["--arch", "starcoder2-3b", "--reduced", "--steps", "3", "--device", "cpu",
         "--save", path])
    out = capsys.readouterr().out
    assert [h["step"] for h in hist] == [0, 2] and int(state["step"]) == 3
    assert all(np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist)
    assert "step     2 loss=" in out and "gnorm=" in out and "saved" in out
    # the reference reads the launcher's checkpoint
    jcfg = JC.get_config("starcoder2-3b", reduced=True)
    like = jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0), jcfg))
    back = JCK.load(path, like)
    got = convert.params_from_jax(jax.tree.map(np.asarray, back),
                                  TC.get_config("starcoder2-3b", reduced=True), device="cpu")
    for a, b in zip(TO.tree_leaves(got), TO.tree_leaves(params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flag", ["--data-par", "--model-par"])
def test_launch_train_refuses_a_mesh(flag):
    """A plain process has one rank: a mesh of two needs torchrun
    (tests/test_torch_mesh.py runs one)."""
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        launch_train.main(["--arch", "starcoder2-3b", "--reduced", flag, "2",
                           "--device", "cpu"])


def test_train_variant_example_on_the_cpu(capsys):
    train_variant.main(["--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "checkpoint roundtrip" in out and "saved variant to" in out


# ---------------------------------------------------------------------------
# the kernels refuse autograd
# ---------------------------------------------------------------------------
def _kernel_calls(requires_grad):
    rng = _rng(5)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) \
        .requires_grad_(requires_grad)  # noqa: E731
    return {
        "flash_attention": lambda: ops.flash_attention(t(1, 8, 2, 32), t(1, 8, 2, 32),
                                                       t(1, 8, 2, 32)),
        "decode_attention": lambda: ops.decode_attention(
            t(1, 2, 32), t(1, 8, 2, 32), t(1, 8, 2, 32), torch.tensor([5], dtype=torch.int32)),
        "ssd_scan": lambda: ops.ssd_scan(t(1, 16, 2, 16), torch.rand(1, 16, 2), -torch.rand(2),
                                         t(1, 16, 1, 8), t(1, 16, 1, 8), chunk=16),
    }


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention", "ssd_scan"])
def test_kernels_refuse_inputs_that_require_grad(kernel):
    with pytest.raises(RuntimeError, match="impl='naive' or impl='chunked'"):
        _kernel_calls(True)[kernel]()
    with torch.no_grad():
        _kernel_calls(True)[kernel]()
    _kernel_calls(False)[kernel]()


@pytest.mark.parametrize("arch", ["starcoder2-3b", "mamba2-2.7b"])
def test_training_through_the_kernel_path_raises(arch):
    cfg = TC.get_config(arch, reduced=True)
    params = TM.init(cfg, seed=0, device="cpu")
    batch = TD.to_device(TD.SyntheticStream(cfg, TD.DataConfig(seq_len=8, batch_size=1))
                         .batch(0), "cpu")
    with pytest.raises(RuntimeError, match="has no backward"):
        _port_grads(params, cfg, batch, impl="kernel")


def test_a_served_batch_does_not_trip_the_guard():
    """The engine serves under ``torch.inference_mode()``: even parameters
    left requiring grad reach the kernels' path without tripping the guard,
    which the same prefill outside it does."""
    name, cfg, acc = TC.get_variant_family("starcoder2-3b")[0]
    srv = StageServer("s", [(name, cfg, acc)], gen_tokens=2, device="cpu")
    for p in TO.tree_leaves(srv.params[name]):
        p.requires_grad_(True)
    assert torch.is_grad_enabled()
    out, _ = srv.process(np.zeros((2, 6), np.int32))
    assert out.shape == (2, 2)
    with pytest.raises(RuntimeError, match="has no backward"):
        TM.prefill(srv.params[name], cfg, {"tokens": torch.zeros((2, 6), dtype=torch.int64)})
