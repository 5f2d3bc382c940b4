"""A stage's decode step as a CUDA graph: captured once, replayed each step.

Eagerly, a decode step of phi-3-vision launches about 2500 operations from
Python, and the host takes about three times the device's time to launch
them.  ``DecodeGraph`` captures one step of ``model.decode_step`` (looked
up on the module when it captures), the argmax, the argmax's copy into the
token buffer, the copy of each new Mamba2 conv window and state into the
static caches, and ``cache_len += 1``; each replay then runs the step from
one launch.  Its inputs are static: the token buffer (B, 1), the 0-d
context length and the caches, which the step reads and writes in place.
A graph holds the shapes it was captured at, so a server keeps one per
(variant, batch rows, cache capacity), each with its own caches
(``StageServer`` on a CUDA device whose parameters and caches are plain
tensors; elsewhere the loop runs eagerly).

The capture runs with the recorder paused (``tracing.paused``), so a graph
holds the same operations whether or not a recording is open, and a replay
counts nothing: no MoE counter, and no kernel wrapper's ``launches``, which
count the wrappers' calls (a replay's kernels are counted by name in a
profiler's trace).
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.models import model as M


class DecodeGraph:
    """One decode step of ``cfg`` at the caches' shapes, captured on
    ``stream`` into the memory pool ``pool``.  ``caches`` (a prefill's)
    give the static caches' shapes and types; their values are not read.
    ``logits`` (B, V) holds the last replay's logits."""

    def __init__(self, params, cfg, caches, stream: torch.cuda.Stream, pool):
        first = next(iter(caches[0].values()))
        dev = first.device
        self.tok = torch.zeros((first.shape[0], 1), dtype=torch.int64, device=dev)
        self.clen = torch.zeros((), dtype=torch.int64, device=dev)
        self.caches = [{k: torch.zeros(t.shape, dtype=t.dtype, device=dev)
                        for k, t in c.items()} for c in caches]
        step = M.decode_step

        def run():
            lg, new = step(params, cfg, self.caches, self.clen, self.tok)
            self.logits = lg
            self.tok.copy_(torch.argmax(lg, dim=-1)[:, None])
            for dst, src in zip(self.caches, new):
                for k, t in src.items():
                    if t is not dst[k]:          # Mamba2's conv and state
                        dst[k].copy_(t)
            self.clen.add_(1)

        self.graph = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            # eagerly first, on the capture's stream: cuBLAS's workspace and
            # K2's arrival counters for this stream exist before the capture
            with tracing.paused():
                run()
                self.graph.capture_begin(pool=pool)
                try:
                    run()
                finally:
                    self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)

    def load(self, tok, caches, cache_len: int) -> None:
        """Start from a prefill: its first token, its caches (every slot is
        overwritten) and the prompt's length."""
        self.tok.copy_(tok)
        for dst, src in zip(self.caches, caches):
            for k, t in src.items():
                if t.shape != dst[k].shape or t.dtype != dst[k].dtype:
                    raise ValueError(f"cache {k!r} {t.dtype} {tuple(t.shape)} does not fit "
                                     f"the graph's {dst[k].dtype} {tuple(dst[k].shape)}")
                dst[k].copy_(t)
        self.clen.fill_(cache_len)

    def replay(self) -> None:
        """One decode step: ``tok`` becomes the next token."""
        self.graph.replay()
