"""Serving launcher: an IPA pipeline on the torch engine.

Builds a pipeline from the assigned architectures' variant families on the
card, profiles every variant (paper §4.2) into the planner's
``StageModel``s, and serves a few batches through the ``PipelineEngine``,
printing tokens, per-stage latencies and the pipeline accuracy score.  The
trace replay with the IPA adapter (``core/adapter.py::run_trace`` in the
reference) comes with the planner slice of the port.

  PYTHONPATH=src python -m repro_torch.launch.serve --pipeline vlm-classify
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import configs
from repro_torch import device as D
from repro_torch.core import profiler as PF
from repro_torch.core.pipeline import PipelineModel
from repro_torch.models import stack as ST
from repro_torch.serving.engine import PipelineEngine, StageServer

# pipelines over the assigned architectures (analogues of the paper's five)
ENGINE_PIPELINES = {
    # video-monitoring analogue: VLM "detector" -> dense classifier
    "vlm-classify": [("phi-3-vision-4.2b", 4), ("yi-34b", 4)],
    # audio-qa analogue: whisper ASR backbone -> code/QA dense model
    "asr-qa": [("whisper-medium", 4), ("starcoder2-3b", 4)],
    # nlp analogue: gemma3 -> qwen2-moe -> mamba2 chain
    "nlp-chain": [("gemma3-27b", 4), ("qwen2-moe-a2.7b", 4),
                  ("mamba2-2.7b", 4)],
}


def build_pipeline(name: str, *, gen_tokens: int = 4, profile_batches=(1, 2, 4),
                   th: float = 2.0, verbose: bool = True,
                   device: D.DeviceLike = None):
    """Returns (PipelineModel for the control plane, PipelineEngine).

    Raises ``NotImplementedError`` before profiling anything if a stage's
    layers come with a later slice of the port (``asr-qa``'s whisper stage
    needs the enc-dec slice)."""
    dev = D.resolve(device)
    for arch, _ in ENGINE_PIPELINES[name]:
        ST.layer_specs(configs.get_config(arch))
    servers = []
    stages = []
    for arch, _ in ENGINE_PIPELINES[name]:
        fam = configs.get_variant_family(arch)
        srv = StageServer(arch, fam, gen_tokens=gen_tokens, device=dev)
        if verbose:
            print(f"profiling stage {arch} ({len(fam)} variants)...",
                  flush=True)
        profs = PF.profile_stage_server(srv, batches=profile_batches)
        stage = PF.build_stage(arch, profs, th=th,
                               batch_choices=profile_batches,
                               max_batch=max(profile_batches))
        servers.append(srv)
        stages.append(stage)
    return PipelineModel(name, tuple(stages)), PipelineEngine(servers)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pipeline", default="vlm-classify",
                    choices=list(ENGINE_PIPELINES))
    ap.add_argument("--batches", type=int, default=3,
                    help="batches to serve after profiling")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    pipe, engine = build_pipeline(args.pipeline)
    for st in pipe.stages:
        print(f"stage {st.name}: SLA {st.sla:.6f} s")
        for v in st.variants:
            print(f"  {v.name}: latency(1) {float(v.latency(1)):.6f} s, "
                  f"base_alloc {v.base_alloc}, accuracy {v.accuracy}")
    print(f"pipeline SLA_P = {pipe.sla:.6f} s")
    rng = np.random.default_rng(args.seed)
    for i in range(args.batches):
        toks = rng.integers(0, 400, (2, 16)).astype(np.int32)
        out, lats = engine.serve(toks)
        print(f"batch {i}: tokens {out.tolist()} stage latencies "
              f"{[f'{l * 1e3:.3f} ms' for l in lats]} PAS {engine.pas:.2f}")


if __name__ == "__main__":
    main()
