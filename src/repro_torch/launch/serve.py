"""Serving launcher: an IPA-managed pipeline on the torch engine.

Builds a pipeline from the assigned architectures' variant families on the
card, profiles every variant (paper §4.2) into the planner's
``StageModel``s, then replays a workload excerpt with the IPA adapter making
variant/batch/replica decisions online (``replay``, which ``main`` calls),
prints the replay's summary and serves a batch through the
``PipelineEngine``, as ``repro/launch/serve.py`` does.

Demand is reactive (``run_trace`` with ``predictor=None``): the LSTM load
predictor comes with ROADMAP item 11.  One card measures one replica, so
every profiled latency is taken at R = 1 and R > 1 is modelled as
l / R^0.75 (``core/profiler.py``).  The adapter's decisions drive its
simulator, as in the reference; the engine keeps its first variants.

  PYTHONPATH=src python -m repro_torch.launch.serve --pipeline vlm-classify \\
      --trace bursty --seconds 120
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --seconds 10
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch import configs
from repro_torch import device as D
from repro_torch.core import adapter as AD
from repro_torch.core import optimizer as OPT
from repro_torch.core import profiler as PF
from repro_torch.core import trace as TR
from repro_torch.core.pipeline import PipelineModel
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
POLICIES = ("ipa", "fa2_low", "fa2_high", "rim")


def build_pipeline(name: str, *, gen_tokens: int = 4, profile_batches=(1, 2, 4),
                   th: float = 2.0, verbose: bool = True,
                   device: D.DeviceLike = None):
    """Returns (PipelineModel for the control plane, PipelineEngine).

    Raises ``NotImplementedError`` before profiling anything if a stage is
    an encoder-decoder model: the engine passes tokens only, and whisper
    needs its frames (ROADMAP R2; ``asr-qa`` fails on the reference's
    engine too)."""
    for arch, _ in ENGINE_PIPELINES[name]:
        if configs.get_config(arch).family == "encdec":
            raise NotImplementedError(
                f"pipeline {name}: stage {arch} is an encoder-decoder model and the "
                "engine passes tokens only, not its frames (ROADMAP R2: the "
                "reference's engine cannot serve it either)")
    dev = D.resolve(device)
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


def replay(pipe: PipelineModel, *, trace: str = "bursty", seconds: int = 120,
           policy: str = "ipa", alpha: float = 10.0, beta: float = 0.5,
           scale_rps: float = 0.25, seed: int = 0) -> AD.TraceResult:
    """IPA's loop on a profiled pipeline: the ``trace`` excerpt of
    ``seconds`` per-second rates, times ``scale_rps``, through
    ``run_trace`` under ``policy`` with the objective alpha * PAS - beta *
    cost, reactive demand and arrivals drawn from ``seed``."""
    rates = TR.excerpt(trace, seconds=seconds) * scale_rps
    obj = OPT.Objective(alpha=alpha, beta=beta, metric="pas")
    return AD.run_trace(pipe, rates, policy=policy, obj=obj, seed=seed)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pipeline", default="vlm-classify",
                    choices=list(ENGINE_PIPELINES))
    ap.add_argument("--trace", default="bursty", choices=list(TR.EXCERPTS))
    ap.add_argument("--seconds", type=int, default=120)
    ap.add_argument("--policy", default="ipa", choices=list(POLICIES))
    ap.add_argument("--alpha", type=float, default=10.0)
    ap.add_argument("--beta", type=float, default=0.5)
    ap.add_argument("--scale-rps", type=float, default=0.25,
                    help="scale the trace to this machine's capacity")
    ap.add_argument("--batches", type=int, default=1,
                    help="batches to serve through the engine after the replay")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    pipe, engine = build_pipeline(args.pipeline, device=args.device)
    for st in pipe.stages:
        print(f"stage {st.name}: SLA {st.sla:.6f} s")
        for v in st.variants:
            print(f"  {v.name}: latency(1) {float(v.latency(1)):.6f} s, "
                  f"base_alloc {v.base_alloc}, accuracy {v.accuracy}")
    print(f"pipeline SLA_P = {pipe.sla:.6f} s")
    res = replay(pipe, trace=args.trace, seconds=args.seconds, policy=args.policy,
                 alpha=args.alpha, beta=args.beta, scale_rps=args.scale_rps,
                 seed=args.seed)
    print(json.dumps(res.summary(), indent=1))

    # the data plane serving a batch beside the replayed decisions
    last = res.intervals[-1]
    print(f"final interval PAS={last.pas:.2f} cost={last.cost:.0f}")
    rng = np.random.default_rng(args.seed)
    for i in range(args.batches):
        toks = rng.integers(0, 400, (2, 16)).astype(np.int32)
        out, lats = engine.serve(toks)
        print(f"engine batch {i}: tokens {out.tolist()} stage latencies "
              f"{[f'{l * 1e3:.3f} ms' for l in lats]} PAS {engine.pas:.2f}")


if __name__ == "__main__":
    main()
