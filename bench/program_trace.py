"""The program's own spans (``repro_torch.tracing``) joined to the device
trace by kernel launch: device time by span, the share of it joined, and
what four per-layer metrics would read from them.  The benchmark's runs do
not run this; ``PERF.md`` (Open questions) lists the edits to
``bench/harness.py`` that would let a ``--trace 1`` run do it.

    python3 bench/program_trace.py --workload <cell> --seeds 31,32 [--seconds 51]
                                   [--windows profiler,spans,spans,profiler] [--out DIR]
    python3 bench/program_trace.py --span-cost

For each seed, in one process: the cell's pipeline built and warmed up as
in a run, then windows of the cell's traffic, by default four traced ones
in the order profiler, spans, spans, profiler.  A "profiler" window is the
window of a ``--trace 1`` run as ``harness.run`` records it: device
activity only, the harness's spans, and its patch of ``prefill`` and
``decode_step``.  A "spans" window records the program's spans in place of
that patch.  A "spans-only" window records the program's spans with no
profiler, and a "plain" window is that of a ``--trace 0`` run.  Each window
prints one JSON line: the cell's per-layer metrics as the benchmark reads
them, and where the program's spans were recorded its numbers
(``program``) and counters, with the device seconds by span
(``device_by_span``) and the idle seconds by span (``idle_gaps``) where
the window was traced.  All lines are written to
``<out>/program_trace_<cell>.json``.

A device operation is joined to the host by the CUDA runtime call that
launched it (the same correlation id): its device time belongs to the
innermost program span open at that call, though the device may run it
later, inside the next span.  ``join_coverage`` is the share of device time
so joined; under ``MIN_COVERAGE`` the numbers read from the device are None.
Operations launched inside a ``count`` span (the device counters' own
reductions) are left out of them.

``--span-cost`` prints what a span costs on this host with no recording
open and inside one, in ns.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import timeit
import types
from pathlib import Path
from typing import Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
MIN_COVERAGE = 0.95


# ---------------------------------------------------------------------------
# device operations and their launches
# ---------------------------------------------------------------------------
def device_ops(events) -> dict:
    """torch.profiler's kineto events -> arrays over the device operations:
    ``start``, ``end`` (device, ns), ``launch`` (host start of the runtime
    call with the same correlation id, ns; -1 where none was recorded) and
    ``name``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    host, ops = {}, []
    for e in events:
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id(),
                            e.name()))
        elif e.correlation_id():
            host[e.correlation_id()] = e.start_ns()
    return {"start": np.array([o[0] for o in ops], dtype=np.int64),
            "end": np.array([o[1] for o in ops], dtype=np.int64),
            "launch": np.array([host.get(o[2], -1) for o in ops], dtype=np.int64),
            "name": [o[3] for o in ops]}


# ---------------------------------------------------------------------------
# spans that nest
# ---------------------------------------------------------------------------
class Nest:
    """Spans that nest, each as (start, end, parent, name) with every parent
    before its children, for finding the innermost span open at a time."""

    def __init__(self, start, end, parent, name):
        self.start = np.asarray(start, dtype=np.int64)
        self.end = np.asarray(end, dtype=np.int64)
        self.parent = np.asarray(parent, dtype=np.int64)
        self.name = list(name)

    @classmethod
    def of_program(cls, spans) -> "Nest":
        """``tracing.Recorder.spans``: in start order, parents recorded."""
        return cls([s.start_ns for s in spans], [s.end_ns for s in spans],
                   [s.parent for s in spans], [s.name for s in spans])

    @classmethod
    def of_harness(cls, done) -> "Nest":
        """The harness's ``Spans.done`` (start, end, name): sorted by start,
        the outer of two that start together first, parents by a sweep."""
        done = sorted(done, key=lambda a: (a[0], -a[1]))
        parent, stack = [], []
        for i, (t0, t1, _) in enumerate(done):
            while stack and done[stack[-1]][1] <= t0:
                stack.pop()
            parent.append(stack[-1] if stack else -1)
            stack.append(i)
        return cls([a[0] for a in done], [a[1] for a in done], parent, [a[2] for a in done])

    def at(self, t) -> np.ndarray:
        """Index of the innermost span open at each time of ``t`` (start <=
        t < end), -1 where none is: the last span to start at or before t,
        or the nearest of its ancestors still open."""
        t = np.asarray(t, dtype=np.int64)
        i = np.searchsorted(self.start, t, side="right") - 1
        while True:
            closed = (i >= 0) & (self.end[np.maximum(i, 0)] <= t)
            if not closed.any():
                return i
            i = np.where(closed, self.parent[np.maximum(i, 0)], i)

    def within(self, names) -> np.ndarray:
        """Per span: whether it or an ancestor is named one of ``names``."""
        out = np.zeros(len(self.name), dtype=bool)
        for i, (n, p) in enumerate(zip(self.name, self.parent)):
            out[i] = n in names or (p >= 0 and out[p])
        return out

    def path(self, i: int) -> List[str]:
        out = []
        while i >= 0:
            out.append(self.name[i])
            i = int(self.parent[i])
        return out[::-1]


# ---------------------------------------------------------------------------
# the join and what is read from it
# ---------------------------------------------------------------------------
def join(ops: dict, prog: Nest) -> np.ndarray:
    """Per device operation: the innermost program span open at its launch,
    -1 where no launch was recorded or none was open."""
    at = prog.at(ops["launch"])
    return np.where(ops["launch"] >= 0, at, -1)


def decode_host_ms(prog: Nest):
    """The mean duration of a ``decode`` span, None where there is none."""
    d = np.flatnonzero(np.array(prog.name) == "decode")
    return float((prog.end[d] - prog.start[d]).mean() * 1e-6) if len(d) else None


def program_numbers(ops: dict, prog: Nest, where: np.ndarray) -> dict:
    """The four per-layer numbers and the join's coverage.  ``where``: the
    joined span of each operation (``join``)."""
    dur = (ops["end"] - ops["start"]).astype(np.float64)
    total = float(dur.sum())
    coverage = float(dur[where >= 0].sum()) / total if total > 0 else 0.0
    decodes = np.flatnonzero(np.array(prog.name) == "decode")
    counted = prog.within({"count"})
    ok = where >= 0
    ok[ok] = ~counted[where[ok]]

    def under(names):
        m = ok.copy()
        m[m] = prog.within(names)[where[m]]
        return m

    out = {"decode_host_ms": decode_host_ms(prog),
           "decode_device_ms": None, "kernels_per_decode": None,
           "moe_dispatch_share": None, "join_coverage": coverage}
    if coverage < MIN_COVERAGE:
        return out
    if len(decodes):
        in_decode = under({"decode"})
        out["decode_device_ms"] = float(dur[in_decode].sum()) * 1e-6 / len(decodes)
        out["kernels_per_decode"] = float(in_decode.sum()) / len(decodes)
    moe_s = float(dur[under({"moe"})].sum())
    if moe_s > 0:
        out["moe_dispatch_share"] = float(dur[under({"moe.dispatch", "moe.combine"})].sum()) / moe_s
    return out


def labeller(harness_nest: Nest, prog: Nest):
    """A label for (harness span, program span) index pairs: the harness's
    path but ``window``, then the program's path below its ``stage``
    (``batch/stage1.yi-34b/decode/mlp``); the program's own ``batch`` and
    ``stage`` are not repeated."""
    cache: Dict[tuple, str] = {}

    def label(h: int, p: int) -> str:
        key = (h, p)
        if key not in cache:
            outer = [n for n in harness_nest.path(h) if n != "window"]
            inner = prog.path(p) if p >= 0 else []
            if "stage" in inner:
                inner = inner[inner.index("stage") + 1:]
            else:
                inner = [n for n in inner if n != "batch"]
            cache[key] = "/".join(outer + inner) or "outside"
        return cache[key]
    return label


def seconds_by_label(t, dur, harness_nest: Nest, prog: Nest, top: int = 10) -> list:
    """Seconds of ``dur`` (ns) by the label of the spans open at ``t``, the
    ``top`` largest."""
    label = labeller(harness_nest, prog)
    h, p = harness_nest.at(t), prog.at(t)
    keys, inv = np.unique(np.stack([h, p], 1), axis=0, return_inverse=True)
    sums = np.bincount(inv.reshape(-1), weights=np.asarray(dur, dtype=np.float64))
    out: Dict[str, float] = {}
    for (hi, pi), s in zip(keys, sums):
        lab = label(int(hi), int(pi))
        out[lab] = out.get(lab, 0.0) + float(s) * 1e-9
    return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])[:top]


def idle_gaps(ops: dict, t0: int, t1: int):
    """Gaps between the union of device intervals inside [t0, t1]:
    (midpoints, durations) in ns."""
    order = np.argsort(ops["start"], kind="stable")
    s, e = ops["start"][order], ops["end"][order]
    ends = np.maximum.accumulate(e)
    new = np.concatenate([[True], s[1:] > ends[:-1]])
    starts = s[new]
    stops = np.concatenate([ends[np.flatnonzero(new)[1:] - 1], ends[-1:]])
    lo = np.concatenate([[t0], stops])
    hi = np.concatenate([starts, [t1]])
    keep = hi > lo
    return (lo[keep] + hi[keep]) // 2, hi[keep] - lo[keep]


def read_spans_window(ops: dict, rec, harness_done) -> dict:
    """What a "spans" window reads from its trace and recording."""
    prog = Nest.of_program(rec.spans)
    outer = Nest.of_harness(harness_done)
    where = join(ops, prog)
    win = [a for a in harness_done if a[2] == "window"][0]
    mids, gaps = idle_gaps(ops, win[0], win[1])
    joined = ops["launch"] >= 0
    by_span = seconds_by_label(ops["launch"][joined], (ops["end"] - ops["start"])[joined],
                               outer, prog)
    unjoined = float((ops["end"] - ops["start"])[~joined].sum()) * 1e-9
    if unjoined > 0:
        by_span = sorted(by_span + [["unjoined", unjoined]], key=lambda kv: -kv[1])[:10]
    return {"program": program_numbers(ops, prog, where),
            "device_by_span": by_span,
            "idle_gaps": seconds_by_label(mids, gaps, outer, prog)}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _without_model_patch(harness):
    real = harness.model_spans
    harness.model_spans = lambda spans: contextlib.nullcontext()
    try:
        yield
    finally:
        harness.model_spans = real


WINDOWS = ("profiler", "spans", "spans-only", "plain")


def window(cell, engine, seed: int, seconds: float, device, kind: str) -> dict:
    """One window of the cell's traffic, of one of ``WINDOWS`` (the
    module's docstring): "spans-only" records the program's spans with no
    profiler, "plain" is the window of a ``--trace 0`` run."""
    from torch.profiler import ProfilerActivity, profile

    from bench import harness
    from repro_torch import tracing
    traced, program = kind in ("profiler", "spans"), kind in ("spans", "spans-only")
    for attempt in range(2):         # CUPTI now and then records no kernel
        spans = harness.Spans(traced)
        gc.collect()
        gc.disable()
        try:
            with contextlib.ExitStack() as stack:
                prof = stack.enter_context(profile(activities=[ProfilerActivity.CUDA])) \
                    if traced else None
                if program:
                    rec = stack.enter_context(tracing.recording())
                    stack.enter_context(_without_model_patch(harness))
                run_, _ = harness.run_window(cell, engine, seed, seconds, spans, device)
                harness._sync(device)
        finally:
            gc.enable()
        tr = harness.read_trace(prof, spans, run_.t_end - run_.t0) if traced else {}
        if tr or not traced:
            break
        print(f"profiler window {attempt + 1} recorded no device kernel", file=sys.stderr)
    ctx = types.SimpleNamespace(cell=cell, run=run_, setup_s=0.0, seconds=seconds, trace=tr,
                                lengths=cell.lengths())
    served = [b for b in run_.batches if b.stage_lats]
    out = {"cell": cell.name, "seed": seed, "window": kind, "batches": len(served),
           "per_layer": {}}
    for m in harness.cell_metrics(cell.name, "per_layer"):
        v = harness.load_metric(m["name"]).read(ctx)
        out["per_layer"][m["name"]] = None if v is None else float(v)
    if program:
        out.update(counters=dict(rec.counters), spans=len(rec.spans),
                   spans_per_batch=len(rec.spans) / max(len(served), 1))
        if tr:
            out.update(read_spans_window(device_ops(prof.profiler.kineto_results.events()), rec,
                                         spans.done))
        else:
            out["program"] = {"decode_host_ms": decode_host_ms(Nest.of_program(rec.spans))}
    return out


def span_cost(n: int = 200_000, reps: int = 7) -> dict:
    """ns a ``with tracing.span("attn"): pass`` costs over an empty
    loop, with no recording open and inside one; the least of ``reps``."""
    from repro_torch import tracing

    def empty():
        for i in range(n):
            pass

    def spans():
        for i in range(n):
            with tracing.span("attn"):
                pass

    def recorded():
        with tracing.recording():
            spans()

    gc.collect()
    gc.disable()
    try:
        best = {f.__name__: min(timeit.repeat(f, number=1, repeat=reps))
                for f in (empty, spans, recorded)}
    finally:
        gc.enable()
    return {"off_ns": (best["spans"] - best["empty"]) / n * 1e9,
            "on_ns": (best["recorded"] - best["empty"]) / n * 1e9}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--windows", default="profiler,spans,spans,profiler",
                    help=f"the windows a seed runs, in order, of {WINDOWS}")
    ap.add_argument("--span-cost", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "results" / "bench"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    if args.span_cost:
        print(json.dumps(span_cost()), flush=True)
        if not args.workload:
            return 0
    import torch

    from bench import harness, spec
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = args.seconds or spec.benchmark()["run_seconds"]
    cell, dev = harness.load_cell(args.workload), torch.device("cuda")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        ws, engine = harness.build(cell, seed, dev)
        harness.warm_up(cell, engine, dev)
        for kind in args.windows.split(","):
            row = window(cell, engine, seed, seconds, dev, kind)
            rows.append(row)
            print(json.dumps(row), flush=True)
        del ws, engine
        gc.collect()
        torch.cuda.empty_cache()
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / f"program_trace_{args.workload}.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
