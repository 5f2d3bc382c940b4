"""PyTorch serving engine: batched prefill + greedy decode with a KV cache,
and hot-swappable model variants (the data plane under IPA's control plane),
after ``repro/serving/engine.py``.

A ``StageServer`` owns one inference *task* (a stage of the pipeline) and a
family of model variants for it.  ``set_variant`` switches the active
parameters -- the serving analogue of the paper's model switching.  A
``PipelineEngine`` chains stages: the token output of stage i is the prompt
of stage i+1.  Prefill attention runs the flash attention kernel and every
decode step the decode attention kernel; a Mamba2 layer's prefill runs the
SSD scan kernel (their plain versions on the CPU).  MoE layers dispatch with
the models' default, ``moe_impl="einsum"``, as the reference engine does;
their capacity is per batch, so the requests of one batch can change each
other's outputs (ROADMAP R5).  While ``tracing.recording()`` is open, a
batch, each stage's call, its prefill, each decode step and the final
synchronize are spans (``repro_torch.tracing``).

On a CUDA device, with plain (not DTensor) parameters and caches, a stage
replays each decode step from a CUDA graph (``decode_graph``), captured on
the first call of each (variant, batch rows, cache capacity); the prefill
runs eagerly.  Elsewhere (the CPU, a mesh) every step runs eagerly.  Each
step adds one to the host counter ``decode.graph`` or ``decode.eager``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import device as D
from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.serving.decode_graph import DecodeGraph


class StageServer:
    def __init__(self, name: str,
                 variants: Sequence[Tuple[str, ModelConfig, float]],
                 *, gen_tokens: int = 8, max_ctx: int = 192, seed: int = 0,
                 params_by_variant: Optional[Dict[str, dict]] = None,
                 device: D.DeviceLike = None):
        self.name = name
        self.gen_tokens = gen_tokens
        self.max_ctx = max_ctx
        self.device = D.resolve(device)
        self.variants: Dict[str, Tuple[ModelConfig, float]] = {}
        self.params: Dict[str, dict] = {}
        for i, (vname, cfg, acc) in enumerate(variants):
            self.variants[vname] = (cfg, acc)
            if params_by_variant and vname in params_by_variant:
                self.params[vname] = params_by_variant[vname]
            else:
                self.params[vname] = M.init(cfg, seed=seed + i, device=self.device)
        self.active = list(self.variants)[0]
        # (variant, rows, capacity) -> DecodeGraph; one capture stream and
        # memory pool for all of them, made at the first capture
        self._graphs: Dict[tuple, DecodeGraph] = {}
        self._capture = None

    # -- control plane hooks -------------------------------------------------
    def set_variant(self, vname: str) -> None:
        if vname not in self.variants:
            raise KeyError(f"unknown variant {vname!r}; have {list(self.variants)}")
        self.active = vname

    @property
    def accuracy(self) -> float:
        return self.variants[self.active][1]

    @property
    def config(self) -> ModelConfig:
        return self.variants[self.active][0]

    # -- data plane -----------------------------------------------------------
    def process(self, tokens: np.ndarray) -> Tuple[np.ndarray, float]:
        """tokens: (B, S) int32 prompts. Greedy-decodes ``gen_tokens``.

        Returns (generated (B, gen_tokens), wall_seconds).
        """
        cfg = self.config
        tokens = np.asarray(tokens, np.int32) % cfg.vocab
        b, s = tokens.shape
        t0 = time.perf_counter()
        with tracing.span("stage"):
            params = self.params[self.active]
            cap = min(self.max_ctx, s + self.gen_tokens)
            toks = torch.from_numpy(tokens).to(self.device)
            with torch.inference_mode():
                with tracing.span("prefill"):
                    hl, caches, _ = M.prefill(params, cfg, {"tokens": toks}, capacity=cap)
                    tok = torch.argmax(hl @ params["embed"].T, dim=-1)[:, None]
                graph = self._decode_graph(params, cfg, caches, (self.active, b, cap))
                out = []
                if graph is None:
                    clen = s
                    for _ in range(self.gen_tokens):
                        out.append(tok)
                        with tracing.span("decode"):
                            lg, caches = M.decode_step(params, cfg, caches, clen, tok)
                            tok = torch.argmax(lg, dim=-1)[:, None]
                            tracing.count("decode.eager", 1)
                        clen += 1
                else:
                    graph.load(tok, caches, s)
                    del caches
                    for _ in range(self.gen_tokens):
                        out.append(graph.tok.clone())
                        with tracing.span("decode"):
                            graph.replay()
                            tracing.count("decode.graph", 1)
                gen = torch.cat(out, dim=1).to(torch.int32)
            with tracing.span("sync"):
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                gen = gen.cpu().numpy()
        return gen, time.perf_counter() - t0

    def _decode_graph(self, params, cfg, caches, key) -> Optional[DecodeGraph]:
        """The decode step's graph for ``key``, captured on its first call,
        or None where the step runs eagerly: off CUDA, or on DTensors."""
        if self.device.type != "cuda" or isinstance(params["embed"], DTensor) or any(
                isinstance(t, DTensor) for c in caches for t in c.values()):
            return None
        graph = self._graphs.get(key)
        if graph is None:
            if self._capture is None:
                self._capture = (torch.cuda.Stream(self.device),
                                 torch.cuda.graph_pool_handle())
            graph = self._graphs[key] = DecodeGraph(params, cfg, caches, *self._capture)
        return graph


class PipelineEngine:
    """Chains StageServers; stage i's generated tokens prompt stage i+1."""

    def __init__(self, stages: Sequence[StageServer]):
        self.stages = list(stages)

    def configure(self, variants: Sequence[str]) -> None:
        for st, v in zip(self.stages, variants):
            st.set_variant(v)

    def serve(self, tokens: np.ndarray) -> Tuple[np.ndarray, List[float]]:
        lats = []
        cur = tokens
        with tracing.span("batch"):
            for st in self.stages:
                cur, lat = st.process(cur)
                lats.append(lat)
        return cur, lats

    @property
    def pas(self) -> float:
        """Pipeline Accuracy Score of the currently active variants (Eq. 8)."""
        p = 1.0
        for st in self.stages:
            p *= st.accuracy / 100.0
        return p * 100.0
