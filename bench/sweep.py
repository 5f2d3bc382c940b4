"""The knee sweep of an open-loop cell, and its SLA by IPA's rule.

    python3 bench/sweep.py --workload <name> [--seconds 30] [--seed 1]

In one process: the cell's pipeline is built once and warmed up; each
stage's batch-1 latency is timed (the median of 5 ``StageServer.process``
calls) and the SLA is 5 x their sum (``core/profiler.py``'s rule); then
one window at each of the traffic file's ``sweep_rates``.  A rate's backlog
grows when the requests due in the window's last third wait a median more
than 1.5 times those of its first third, or the queue still holds more than
a batch when the last request is due.  The knee is the highest rate whose
backlog does not grow; the cell's rate is set to 0.8 of it by hand in its
traffic file.  Writes ``<out>/sweep_<name>.json`` (``--out``, by default
``results/bench``).
"""
import argparse
import copy
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def trend(run):
    recs = sorted(run.recs, key=lambda r: r.due)
    third = max(len(recs) // 3, 1)
    first = statistics.median(r.latency for r in recs[:third])
    last = statistics.median(r.latency for r in recs[-third:])
    t_last = recs[-1].due
    queued = sum(1 for r in recs if r.popped > t_last)
    return first, last, queued


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=str(ROOT / "results" / "bench"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch
    from bench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cell = harness.load_cell(args.workload)
    ws, engine = harness.build(cell, args.seed, dev)
    harness.warm_up(cell, engine, dev)
    out = {"workload": args.workload, "card": torch.cuda.get_device_name(), "rates": []}
    rng = np.random.default_rng(0)
    lat1, prompt = [], cell.traffic["prompt_tokens"]
    for st in engine.stages:
        toks = rng.integers(0, st.config.vocab, (1, prompt), dtype=np.int32)
        times = [st.process(toks)[1] for _ in range(5)]
        lat1.append(statistics.median(times))
        prompt = cell.traffic["gen_tokens"]
    out["batch1_s"] = lat1
    out["sla_s"] = 5.0 * sum(lat1)
    print(f"batch-1 latency by stage {lat1}; SLA 5 x sum = {out['sla_s']:.4f} s", flush=True)
    spans = harness.Spans(False)
    knee = None
    for rate in cell.traffic["sweep_rates"]:
        tr = dict(copy.deepcopy(cell.traffic), rate_rps=rate)
        c = dataclasses.replace(cell, traffic=tr)
        t = time.perf_counter()
        run, _ = harness.run_window(c, engine, args.seed, args.seconds, spans, dev)
        first, last, queued = trend(run)
        lat = sorted(r.latency for r in run.recs)
        sizes = [len(b.rids) for b in run.batches]
        serve = [sum(b.stage_lats) for b in run.batches if b.stage_lats]
        grows = last > 1.5 * first or queued > tr["batch_size"]
        row = {"rate_rps": rate, "requests": len(lat), "p50_s": lat[len(lat) // 2],
               "p95_s": lat[int(0.95 * len(lat)) - 1], "first_third_median_s": first,
               "last_third_median_s": last, "queued_at_last_due": queued,
               "mean_batch": statistics.mean(sizes), "mean_batch_s": statistics.mean(serve),
               "wall_s": time.perf_counter() - t, "grows": grows}
        out["rates"].append(row)
        print(json.dumps(row), flush=True)
        if not grows:
            knee = rate
    out["knee_rps"] = knee
    print(f"knee {knee} requests/s; 0.8 of it {0.8 * knee if knee else None}", flush=True)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / f"sweep_{args.workload}.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
