"""Load predictor (paper §3 "Predictor" + §5.5), after
``repro/core/predictor.py``.

A 25-unit LSTM + 1-unit dense head, written out cell by cell on tensors as
the reference's ``lax.scan`` is (gates i, f, g, o from one (., 4H) product;
the forget gate takes ``sigmoid(f + 1.0)``): input = the past 120 s of
per-second load, output = the *max* load of the next 20 s.  Trained with
the port's AdamW on the reference's windows and batch draws.  Also provides
the reactive (last-window) and oracle (ground-truth future) predictors used
in the Fig.-16 ablation, and SMAPE; those and the windows are numpy, copied
from the reference.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.training import optim

HISTORY = 120          # seconds of history fed to the LSTM
HORIZON = 20           # predict max load over the next 20 s
HIDDEN = 25            # paper: 25-unit LSTM layer


def init_lstm(gen: torch.Generator, hidden: int = HIDDEN):
    """The reference's distributions and scales, drawn from ``gen`` on its
    device (the numbers differ from ``jax.random``'s)."""
    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    s_in = 1.0
    s_h = 1.0 / torch.sqrt(torch.tensor(hidden, dtype=torch.float32, device=gen.device))
    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=gen.device)  # noqa: E731
    return {
        "w_x": normal(1, 4 * hidden) * s_in * 0.1,
        "w_h": normal(hidden, 4 * hidden) * s_h,
        "b": zeros(4 * hidden),
        "w_out": normal(hidden, 1) * s_h,
        "b_out": zeros(1),
    }


def lstm_params_from_jax(params_np, *, device: D.DeviceLike = None):
    """The reference's LSTM parameters (numpy leaves) as the port's."""
    dev = D.resolve(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
            for k, v in params_np.items()}


def lstm_apply(params, x):
    """x: (B, T) normalized loads -> (B,) prediction (normalized)."""
    b, t = x.shape
    h = params["w_h"].shape[0]
    hs = torch.zeros((b, h), dtype=torch.float32, device=x.device)
    cs = torch.zeros((b, h), dtype=torch.float32, device=x.device)
    for step in range(t):
        gates = x[:, step, None] @ params["w_x"] + hs @ params["w_h"] + params["b"]
        i, f, g, o = gates.chunk(4, dim=-1)
        cs = torch.sigmoid(f + 1.0) * cs + torch.sigmoid(i) * torch.tanh(g)
        hs = torch.sigmoid(o) * torch.tanh(cs)
    return (hs @ params["w_out"] + params["b_out"])[:, 0]


def make_windows(trace: np.ndarray, stride: int = 10
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(X: (N, HISTORY), y: (N,) = max of next HORIZON seconds)."""
    xs, ys = [], []
    for s in range(0, len(trace) - HISTORY - HORIZON, stride):
        xs.append(trace[s:s + HISTORY])
        ys.append(trace[s + HISTORY:s + HISTORY + HORIZON].max())
    return np.asarray(xs, np.float32), np.asarray(ys, np.float32)


def smape(pred: np.ndarray, true: np.ndarray) -> float:
    pred, true = np.asarray(pred), np.asarray(true)
    return float(100.0 * np.mean(
        np.abs(pred - true) / ((np.abs(pred) + np.abs(true)) / 2 + 1e-9)))


def fit(params, Xn: np.ndarray, yn: np.ndarray, *, steps: int, batch: int, lr: float,
        seed: int, verbose: bool = False):
    """The reference's training loop on normalized windows: AdamW (warmup 20,
    cosine over ``steps``, no decay, clip 1), MSE, batches of ``batch``
    windows drawn by ``np.random.default_rng(seed).integers``.  Updates
    ``params`` in place; returns (params, the loss of every step)."""
    dev = params["w_h"].device
    ocfg = optim.AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps,
                             weight_decay=0.0, grad_clip=1.0)
    state = optim.init_state(params)
    leaves = optim.tree_leaves(params)
    losses = []
    rng = np.random.default_rng(seed)
    for i in range(steps):
        idx = rng.integers(len(Xn), size=batch)
        xb = torch.from_numpy(Xn[idx]).to(dev)
        yb = torch.from_numpy(yn[idx]).to(dev)
        for p in leaves:
            p.requires_grad_(True)
        loss = torch.mean((lstm_apply(params, xb) - yb) ** 2)
        flat = iter(torch.autograd.grad(loss, leaves))
        for p in leaves:
            p.requires_grad_(False)
        grads = optim.tree_map(lambda _: next(flat), params)
        params, state, _ = optim.apply_updates(params, grads, state, ocfg)
        losses.append(loss.detach())
        if verbose and i % 100 == 0:
            print(f"lstm step {i} mse={float(loss):.4f}")
    return params, [float(x) for x in torch.stack(losses).cpu()] if losses else []


@dataclasses.dataclass
class LSTMPredictor:
    params: dict
    mean: float
    std: float

    @classmethod
    def train(cls, trace: np.ndarray, *, steps: int = 400, batch: int = 128,
              lr: float = 3e-3, seed: int = 0, stride: int = 10,
              verbose: bool = False, device: D.DeviceLike = None) -> "LSTMPredictor":
        X, y = make_windows(trace, stride=stride)
        mean, std = float(X.mean()), float(X.std() + 1e-9)
        Xn, yn = (X - mean) / std, (y - mean) / std
        params = init_lstm(torch.Generator(device=D.resolve(device)).manual_seed(seed))
        params, _ = fit(params, Xn, yn, steps=steps, batch=batch, lr=lr, seed=seed,
                        verbose=verbose)
        return cls(params=params, mean=mean, std=std)

    @torch.no_grad()
    def predict(self, history: np.ndarray) -> float:
        """history: most recent >= HISTORY per-second loads."""
        h = np.asarray(history, np.float32)[-HISTORY:]
        if len(h) < HISTORY:
            h = np.pad(h, (HISTORY - len(h), 0), mode="edge")
        x = (h[None] - self.mean) / self.std
        out = float(lstm_apply(self.params, self._tensor(x))[0])
        return max(out * self.std + self.mean, 0.1)

    @torch.no_grad()
    def predict_batch(self, X: np.ndarray) -> np.ndarray:
        xn = (np.asarray(X, np.float32) - self.mean) / self.std
        out = lstm_apply(self.params, self._tensor(xn)).cpu().numpy()
        return np.maximum(out * self.std + self.mean, 0.1)

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.params["w_h"].device)


class ReactivePredictor:
    """No look-ahead: uses the recent max as the next-interval estimate."""

    def predict(self, history: np.ndarray) -> float:
        h = np.asarray(history, np.float64)
        return float(h[-HORIZON:].max()) if len(h) else 1.0


class OraclePredictor:
    """Ground-truth future max (the Fig.-16 'baseline predictor')."""

    def __init__(self, trace: np.ndarray, horizon: int = HORIZON):
        self.trace = np.asarray(trace, np.float64)
        self.horizon = int(horizon)

    def predict_at(self, now_s: int) -> float:
        fut = self.trace[now_s:now_s + self.horizon]
        return float(fut.max()) if len(fut) else float(self.trace[-1])

    @classmethod
    def for_traces(cls, traces, horizon: int = HORIZON):
        """One oracle per per-pipeline trace — the ``oracles`` argument of
        ``adapter.run_cluster_trace``."""
        return [cls(t, horizon) for t in traces]


def train_cluster_predictors(traces, **train_kw) -> List[LSTMPredictor]:
    """One ``LSTMPredictor`` per per-pipeline trace (each pipeline's load
    shape differs, so they do not share a model) — the ``predictors``
    argument of ``adapter.run_cluster_trace``."""
    return [LSTMPredictor.train(np.asarray(t, np.float32), **train_kw)
            for t in traces]
