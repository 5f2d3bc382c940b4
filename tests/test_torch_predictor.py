"""repro_torch.core.predictor against repro.core.predictor: the LSTM's
forward on the reference's converted parameters (within 1e-5), its
training loop on the reference's init and batch draws (losses within 1e-4
over 10 steps), the numpy windows, SMAPE, reactive and oracle predictors
(exact), and ``run_trace`` driven by an LSTM predictor equal to the
reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adapter as JAD
from repro.core import optimizer as JOPT
from repro.core import paper_profiles as JPP
from repro.core import predictor as JPR
from repro.core import trace as JTR
from repro.training import optim as JO
from repro_torch.core import adapter as TAD
from repro_torch.core import optimizer as TOPT
from repro_torch.core import paper_profiles as TPP
from repro_torch.core import predictor as TPR
from repro_torch.core import trace as TTR

STEPS = 10


def _port_params(jparams):
    return TPR.lstm_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def trained():
    """The reference's LSTM init (seed 0), its normalized windows of a day
    of the seed-3 trace, and the losses and params of its own training loop
    (``LSTMPredictor.train``'s, written out) over STEPS steps."""
    params = JPR.init_lstm(jax.random.PRNGKey(0))
    trace = JTR.synth_trace(86_400, JTR.TraceConfig(seed=3))
    X, y = JPR.make_windows(trace, stride=40)
    mean, std = float(X.mean()), float(X.std() + 1e-9)
    Xn, yn = (X - mean) / std, (y - mean) / std
    ocfg = JO.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=STEPS,
                          weight_decay=0.0, grad_clip=1.0)

    @jax.jit
    def step(p, state, xb, yb):
        loss, g = jax.value_and_grad(lambda p: jnp.mean((JPR.lstm_apply(p, xb) - yb) ** 2))(p)
        p, state, _ = JO.apply_updates(p, g, state, ocfg)
        return p, state, loss
    rng = np.random.default_rng(0)
    p, state, losses = params, JO.init_state(params), []
    for _ in range(STEPS):
        idx = rng.integers(len(Xn), size=128)
        p, state, loss = step(p, state, jnp.asarray(Xn[idx]), jnp.asarray(yn[idx]))
        losses.append(float(loss))
    return dict(init=params, Xn=Xn, yn=yn, mean=mean, std=std, losses=losses,
                params=p, trace=trace)


@pytest.mark.parametrize("b", [1, 5, 64])
def test_lstm_forward_on_converted_params(trained, b):
    x = np.random.default_rng(b).standard_normal((b, TPR.HISTORY)).astype(np.float32)
    for params in (trained["init"], trained["params"]):
        want = np.asarray(JPR.lstm_apply(params, jnp.asarray(x)))
        got = TPR.lstm_apply(_port_params(params), torch.from_numpy(x)).numpy()
        assert got.shape == (b,)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_training_steps_on_the_reference_init_and_batches(trained):
    params = _port_params(trained["init"])
    params, losses = TPR.fit(params, trained["Xn"], trained["yn"], steps=STEPS, batch=128,
                             lr=3e-3, seed=0)
    np.testing.assert_allclose(losses, trained["losses"], atol=1e-4, rtol=0)
    assert losses[-1] < losses[0]
    assert not any(p.requires_grad for p in params.values())


def test_init_lstm_shapes_and_scales():
    p = TPR.init_lstm(torch.Generator().manual_seed(0))
    want = JPR.init_lstm(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in want.items()}
    assert float(p["b"].abs().max()) == 0.0 and float(p["b_out"].abs().max()) == 0.0
    big = TPR.init_lstm(torch.Generator().manual_seed(1), hidden=400)
    assert float(big["w_x"].std()) == pytest.approx(0.1, rel=0.05)
    assert float(big["w_h"].std()) == pytest.approx(400 ** -0.5, rel=0.05)


def test_windows_and_smape_are_the_reference(trained):
    t = trained["trace"][:3000]
    for stride in (1, 7, 40):
        got, want = TPR.make_windows(t, stride), JPR.make_windows(t, stride)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    X, y = TPR.make_windows(t, 7)
    assert TPR.smape(X[:, -1], y) == JPR.smape(X[:, -1], y)
    assert TPR.smape(np.ones(5), np.ones(5)) == 0.0
    assert (TPR.HISTORY, TPR.HORIZON, TPR.HIDDEN) == (JPR.HISTORY, JPR.HORIZON, JPR.HIDDEN)


def _predictors(trained):
    """The reference's trained LSTM, and the port's with its parameters."""
    want = JPR.LSTMPredictor(trained["params"], trained["mean"], trained["std"])
    got = TPR.LSTMPredictor(_port_params(trained["params"]), trained["mean"], trained["std"])
    return got, want


def test_predict_and_predict_batch_as_the_reference(trained):
    got, want = _predictors(trained)
    t = trained["trace"]
    for h in (t[:500], t[1000:1030], t[:1], np.full(200, 1e-3)):
        assert got.predict(h) == pytest.approx(want.predict(h), rel=1e-5)
    assert got.predict(np.full(200, 1e-3)) >= 0.1
    X, _ = TPR.make_windows(t[:5000], stride=50)
    np.testing.assert_allclose(got.predict_batch(X), want.predict_batch(X), rtol=1e-5)
    assert got.predict_batch(X).min() >= 0.1


def test_reactive_and_oracle_are_the_reference():
    hist = np.array([1.0, 2.0, 9.0] + [3.0] * 30)
    assert TPR.ReactivePredictor().predict(hist) == JPR.ReactivePredictor().predict(hist)
    assert TPR.ReactivePredictor().predict(np.array([])) == 1.0
    tr = np.arange(100, dtype=float)
    for now in (0, 10, 90, 100, 150):
        assert TPR.OraclePredictor(tr).predict_at(now) == JPR.OraclePredictor(tr).predict_at(now)
    assert [o.horizon for o in TPR.OraclePredictor.for_traces([tr, tr], 7)] == [7, 7]


def test_train_cluster_predictors_one_per_trace(trained):
    traces = [trained["trace"][:1200], trained["trace"][2000:3400]]
    preds = TPR.train_cluster_predictors(traces, steps=2, batch=8, stride=50, device="cpu")
    assert len(preds) == 2 and preds[0].mean != preds[1].mean
    assert all(p.predict(t) >= 0.1 for p, t in zip(preds, traces))


def test_lstm_predictor_train_normalizes_as_the_reference(trained):
    """``train``'s windows, mean and std are the reference's; its params move."""
    t = np.asarray(trained["trace"][:4000], np.float32)
    got = TPR.LSTMPredictor.train(t, steps=3, batch=16, stride=40, device="cpu")
    X, _ = JPR.make_windows(t, stride=40)
    assert (got.mean, got.std) == (float(X.mean()), float(X.std() + 1e-9))
    init = TPR.init_lstm(torch.Generator().manual_seed(0))
    assert not torch.equal(got.params["w_h"], init["w_h"])


def test_run_trace_with_the_reference_lstm(trained):
    """Fig. 16's LSTM arm on the video pipeline: the same decisions, interval
    for interval, as the reference's ``run_trace`` with its own LSTM."""
    got_pred, want_pred = _predictors(trained)

    def run(AD, OPT, PP, TR, pred):
        obj = OPT.Objective(**PP.PAPER_WEIGHTS["video"], metric="pas")
        rates = TR.excerpt("bursty", seconds=120)
        return AD.run_trace(PP.video(), rates, policy="ipa", obj=obj, seed=7, predictor=pred)
    got = run(TAD, TOPT, TPP, TTR, got_pred)
    want = run(JAD, JOPT, JPP, JTR, want_pred)
    for a, b in zip(got.intervals, want.intervals):
        assert a.lam_hat == pytest.approx(b.lam_hat, rel=1e-6)
        assert dataclasses.astuple(dataclasses.replace(a, lam_hat=0.0, solve_time=0.0)) == \
            dataclasses.astuple(dataclasses.replace(b, lam_hat=0.0, solve_time=0.0))
    assert len(got.intervals) == len(want.intervals) == 12
    assert got.summary() == want.summary()
    assert (got.arrived, got.completed, got.dropped) == (want.arrived, want.completed,
                                                         want.dropped)
    # the batch-formation timeouts follow lam_hat (Eq. 7), which the two
    # LSTMs give a few f32 ulps apart: the latencies move by as little
    assert len(got.latencies) == len(want.latencies)
    np.testing.assert_allclose(got.latencies, want.latencies, atol=1e-6, rtol=0)
