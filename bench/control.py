"""Readings that set a cell's correctness limit; the benchmark's runs do
not run this.

    python3 bench/control.py --workload <name> --seeds 11,12,13 [--control 3] [--seconds 10]

In one process, for each seed: the cell's pipeline built from that seed,
warmed up and driven for a short window at the cell's own load, then the
served tokens of the run's sample against the plain reference (the
program's readings: ``logit_gap``, ``mean_gap``, ``off_top_share``), and
for the first ``--control`` seeds the fp8 control at the same positions
(``control``: the same statistics of the reference's gaps of the tokens the
fp8 control puts first).  Each limit lies between the largest program
reading and the smallest control reading of its number.  Writes
``<out>/control_<name>.json`` (``--out``, by default ``results/bench``).
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=str(ROOT / "results" / "bench"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cell = harness.load_cell(args.workload)
    rows = []
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ws, engine = harness.build(cell, seed, dev)
        harness.warm_up(cell, engine, dev)
        run, captured = harness.run_window(cell, engine, seed, args.seconds,
                                           harness.Spans(False), dev)
        del engine
        got = harness.check(cell, ws, run, captured, seed, dev, control=n < args.control)
        got.update(seed=seed, failed=sum(r.failed for r in run.recs),
                   requests=len(run.recs), wall_s=time.perf_counter() - t)
        rows.append(got)
        print(json.dumps(got), flush=True)
        del ws, run, captured
        gc.collect()
        torch.cuda.empty_cache()
    names = ("logit_gap", "mean_gap", "off_top_share")
    ctl = [r["control"] for r in rows if "control" in r]
    summary = {"workload": args.workload, "card": torch.cuda.get_device_name(),
               "program_max": {k: max(r[k] for r in rows) for k in names},
               "control_min": {k: min(c[k] for c in ctl) for k in names} if ctl else None,
               "rows": rows}
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}), flush=True)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / f"control_{args.workload}.json").write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
