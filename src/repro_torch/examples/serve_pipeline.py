"""End-to-end example: serve a small pipeline of real models, with batched
requests, under IPA's control on the torch engine -- the counterpart of the
reference's ``examples/serve_pipeline.py``, with the same arguments.

Two assigned architectures (the phi-3-vision -> yi-34b reduced families)
form a video-monitoring-style pipeline: the profiler measures each variant's
prefill + decode latency on the card (at one replica; more are modelled as
l / R^0.75), Eq. 1 computes the base allocations, and the IPA adapter
replays a workload excerpt with reactive demand, switching variants,
batches and replicas in its simulator.  Finally a batch of 4 requests is
served through both stages of the engine.

  PYTHONPATH=src python -m repro_torch.examples.serve_pipeline
  PYTHONPATH=src python -m repro_torch.examples.serve_pipeline --device cpu
"""
import argparse

import numpy as np

from repro_torch.launch.serve import build_pipeline, replay


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    pipe, engine = build_pipeline("vlm-classify", gen_tokens=2,
                                  profile_batches=(1, 2), th=0.5, device=args.device)
    print(f"profiled pipeline SLA_P = {pipe.sla:.2f}s")
    for st in pipe.stages:
        for v in st.variants:
            print(f"  {st.name}/{v.name}: l(1)={v.latency(1)*1e3:.0f}ms "
                  f"R={v.base_alloc} acc={v.accuracy}")

    # the fluctuating excerpt at a tenth of its rates
    res = replay(pipe, trace="fluctuating", seconds=60, scale_rps=0.1,
                 policy="ipa", alpha=10.0, beta=0.5, seed=0)
    print("adaptation summary:", res.summary())

    final = res.intervals[-1]
    print(f"final interval: PAS={final.pas:.2f} cost={final.cost:.0f}")
    prompts = np.random.default_rng(0).integers(0, 400, (4, 12)).astype(np.int32)
    out, lats = engine.serve(prompts)
    print(f"served batch of 4 through 2 stages -> output tokens {out.shape}, "
          f"stage latencies {[f'{l*1e3:.0f}ms' for l in lats]}, "
          f"engine PAS={engine.pas:.2f}")


if __name__ == "__main__":
    main()
