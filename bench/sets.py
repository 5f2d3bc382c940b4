"""Two sets of runs of one cell, and the spreads that its bounds are set from.

    python3 bench/sets.py --workload <name> --seeds 11,12,13,14,15,16 [--traced 21,22,23]
                          [--seconds <run_seconds>] [--out results/bench/sets]

Runs ``bench/run.py`` once a process, one at a time: set A over the seeds
in order, set B over the same seeds, then one ``--trace 1`` run on each of
the ``--traced`` seeds.  Each run's standard output and error go to
``<out>/<workload>.<set>.<seed>.out`` and ``.err``.  Then, for each
end-to-end metric: each set's median and spread (the interquartile range
by ``statistics.quantiles(values, n=4)`` over the median), five times the
wider spread, the spread with each set's run farthest from its median left
out (the mean over the two sets), the spread of every run together, and
set B's median over set A's.  With every run's ``correct``, its compared
numbers and the peak memory, and the traced runs' per-layer metrics.  The
summary is printed and written to ``<out>/<workload>.json``.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def without_farthest(values) -> list:
    med = statistics.median(values)
    v = list(values)
    v.remove(max(v, key=lambda x: abs(x - med)))
    return v


def summarise(set_a: list, set_b: list) -> dict:
    """Per end-to-end metric, from two sets of result lines."""
    out = {}
    for m in set_a[0]["metrics"]:
        a = [r["metrics"][m]["value"] for r in set_a]
        b = [r["metrics"][m]["value"] for r in set_b]
        sa, sb = spread(a), spread(b)
        out[m] = {"median": [statistics.median(a), statistics.median(b)], "spread": [sa, sb],
                  "five_times_wider": 5 * max(sa, sb),
                  "farthest_left_out": statistics.mean([spread(without_farthest(a)),
                                                        spread(without_farthest(b))]),
                  "all_runs": spread(a + b),
                  "b_over_a": statistics.median(b) / statistics.median(a) - 1, "values": [a, b]}
    return out


def run_one(workload, seed, seconds, trace, out: Path, tag: str):
    stem = out / f"{workload}.{tag}.{seed}"
    t = time.perf_counter()
    with open(f"{stem}.out", "w") as fo, open(f"{stem}.err", "w") as fe:
        rc = subprocess.call([sys.executable, str(ROOT / "bench" / "run.py"), "--workload", workload,
                              "--seed", str(seed), "--seconds", str(seconds),
                              "--trace", str(int(trace))], stdout=fo, stderr=fe, cwd=ROOT)
    wall = time.perf_counter() - t
    lines = Path(f"{stem}.out").read_text().strip().splitlines()
    res = json.loads(lines[-1]) if rc == 0 and lines else None
    print(f"== {workload} {tag} seed {seed} trace {int(trace)} rc {rc} wall {wall:.1f} s", flush=True)
    if res is None:
        print(Path(f"{stem}.err").read_text()[-2000:], flush=True)
    else:
        print(json.dumps({k: res[k] for k in ("correct", "metrics", "checks")}), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--traced", default="")
    ap.add_argument("--seconds", type=int, default=None)
    ap.add_argument("--out", default=str(ROOT / "results" / "bench" / "sets"))
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or bench["run_seconds"]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    except FileNotFoundError:
        card = "no nvidia-smi"
    print(card, flush=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    sets = {tag: [run_one(args.workload, s, seconds, False, out, tag) for s in seeds]
            for tag in ("A", "B")}
    traced = [run_one(args.workload, int(s), seconds, True, out, "T")
              for s in args.traced.split(",") if s]
    every = sets["A"] + sets["B"] + traced
    summary = {"workload": args.workload, "card": card, "seconds": seconds, "seeds": seeds,
               "correct": [r is not None and r["correct"] for r in every],
               "checks": [r and r["checks"] for r in every],
               "memory_peak_bytes": sorted({r["device"]["memory_peak_bytes"] for r in every if r}),
               "traced": [r and dict(metrics={k: v["value"] for k, v in r["metrics"].items()},
                                     busy_s=r["device"].get("busy_s"),
                                     window_s=r["device"].get("window_s"),
                                     breakdown=r.get("breakdown")) for r in traced]}
    if all(sets["A"]) and all(sets["B"]):
        summary["end_to_end"] = summarise(sets["A"], sets["B"])
        summary["diag"] = [r.get("diag") for r in sets["A"] + sets["B"]]
    (out / f"{args.workload}.json").write_text(json.dumps(summary, indent=1))
    for m, s in summary.get("end_to_end", {}).items():
        print(f"{m}: medians {s['median']}, spreads {s['spread']}, x5 {s['five_times_wider']:.4f}, "
              f"farthest left out {s['farthest_left_out']:.4f}, all runs {s['all_runs']:.4f}, "
              f"B/A - 1 {s['b_over_a']:+.4f}", flush=True)
    print(json.dumps({k: summary[k] for k in ("correct", "memory_peak_bytes", "traced")}), flush=True)
    return 0 if all(summary["correct"]) else 1


if __name__ == "__main__":
    sys.exit(main())
