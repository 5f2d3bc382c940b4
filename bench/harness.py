"""One run of one cell: build the pipeline from the cell's configuration,
warm it up, drive the window with the cell's traffic, check what it served
against the plain reference, and read the metrics.

Everything that belongs to a configuration, a traffic mix, an architecture
or a metric is found by name: ``bench/configs/<config>.json``,
``bench/traffic/<cell>.json``, each stage's ``bench/layouts/<layout>.py``
and ``bench/reference/<layout>.py`` (``bench/spec.py::layout``), and
``bench/metrics/<metric>.py`` (each metric file has ``LAYER``, ``UNIT``,
``SOURCE`` and ``read(ctx)``, which returns a number or None where it finds
nothing to read).  The program is taken through its entry points only:
``StageServer`` and ``PipelineEngine`` (``serving/engine.py``) and
``CentralQueue`` (``serving/batching.py``).  The harness records spans
around the calls into each layer: a batch, a stage's ``process``, the
model's ``prefill`` and ``decode_step``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import math
import sys
import time
import types
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bench import spec, weights
from bench.reference import model as ref
from bench.traffic import arrivals, drivers

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that the port's runs may not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_metric(name: str):
    path = spec.BENCH_DIR / "metrics" / f"{name}.py"
    mod = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    m = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(m)
    return m


def cell_metrics(cell: str, kind: str) -> List[dict]:
    return [m for m in spec.benchmark()[kind] if cell in m.get("workloads", [cell])]


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
class Spans:
    """Named host spans (start and end on the wall clock in ns, which is
    the clock of the profiler's timestamps) when a run is traced, and
    nothing otherwise."""

    def __init__(self, on: bool):
        self.on = on
        self.done: List[tuple] = []

    @contextlib.contextmanager
    def _span(self, name):
        t = time.time_ns()
        try:
            yield
        finally:
            self.done.append((t, time.time_ns(), name))

    def __call__(self, name: str):
        return self._span(name) if self.on else contextlib.nullcontext()


@contextlib.contextmanager
def model_spans(spans: Spans):
    """Spans around the model's prefill and decode_step, which the engine
    looks up on ``repro_torch.models.model`` at each call."""
    from repro_torch.models import model as M
    if not spans.on:
        yield
        return
    real = M.prefill, M.decode_step

    def prefill(*a, **k):
        with spans("prefill"):
            return real[0](*a, **k)

    def decode_step(*a, **k):
        with spans("decode"):
            return real[1](*a, **k)
    M.prefill, M.decode_step = prefill, decode_step
    try:
        yield
    finally:
        M.prefill, M.decode_step = real


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict

    @property
    def stages(self) -> List[dict]:
        return self.config["stages"]

    def lengths(self) -> List[tuple]:
        """(prompt, gen) of each stage: a stage's prompt is the previous
        stage's generated tokens."""
        out, prompt = [], self.traffic["prompt_tokens"]
        for _ in self.stages:
            out.append((prompt, self.traffic["gen_tokens"]))
            prompt = self.traffic["gen_tokens"]
        return out


def load_cell(name: str) -> Cell:
    w = spec.workload(name)
    return Cell(name, spec.config(w["config"]), spec.traffic(name))


def build(cell: Cell, seed: int, device):
    """The benchmark's weights, and the program's engine over them."""
    from repro_torch.serving.engine import PipelineEngine, StageServer
    ws, servers = [], []
    for k, (st, (prompt, gen)) in enumerate(zip(cell.stages, cell.lengths())):
        w = weights.make_weights(st, seed, k, device)
        ws.append(w)
        lay = spec.layout(st)
        servers.append(StageServer(st["arch_id"], [(st["arch_id"], lay.port_config(st), 0.0)],
                                   gen_tokens=gen, max_ctx=prompt + gen,
                                   params_by_variant={st["arch_id"]: lay.to_port(w, st)},
                                   device=device))
    return ws, PipelineEngine(servers)


def prompt_maker(cell: Cell, seed: int) -> Callable[[int], np.ndarray]:
    s, v = cell.traffic["prompt_tokens"], cell.stages[0]["vocab_size"]
    return lambda i: np.random.default_rng([seed, 1, i]).integers(0, v, s, dtype=np.int32)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_window(cell: Cell, engine, seed: int, seconds: float, spans: Spans, device):
    """Drive the engine with the cell's traffic; returns the driver's Run
    and each batch's (stage input, stage output) pairs."""
    from repro_torch.serving.batching import CentralQueue
    tr = cell.traffic
    captured: List[list] = []
    for k, st in enumerate(engine.stages):
        def process(tokens, _real=st.process, _k=k, _name=st.name, _v=st.config.vocab):
            with spans(f"stage{_k}.{_name}"):
                out, lat = _real(tokens)
            captured[-1].append((np.asarray(tokens, np.int32) % _v, out))
            return out, lat
        st.process = process

    def serve(tokens):
        captured.append([])
        with spans("batch"):
            return engine.serve(tokens)

    def sleep(dt):
        with spans("wait"):
            time.sleep(dt)

    queue = CentralQueue(batch_size=tr["batch_size"], max_wait=tr["max_wait_s"])
    prompt = prompt_maker(cell, seed)
    with model_spans(spans), spans("window"):
        if tr["loop"] == "open":
            run = drivers.run_open(queue, serve, prompt, arrivals.offsets(tr, seconds, seed),
                                   time.perf_counter, sleep)
        else:
            run = drivers.run_closed(queue, serve, prompt, tr["clients"], seconds,
                                     time.perf_counter, sleep)
    for st in engine.stages:
        del st.process
    return run, captured


def warm_up(cell: Cell, engine, device):
    """Serve one batch of each size the cell's traffic forms."""
    s, v = cell.traffic["prompt_tokens"], cell.stages[0]["vocab_size"]
    rng = np.random.default_rng(0)
    for b in cell.traffic["warm_batches"]:
        engine.serve(rng.integers(0, v, (b, s), dtype=np.int32))
    _sync(device)


def check(cell: Cell, ws, run, captured, seed: int, device, control=False):
    """The served tokens of a sample of whole batches, drawn from the seed,
    against the plain reference: statistics (``gap_stats``) of the gap by
    which a served token's reference logit lies below the reference's best.
    With ``control``, the same of the fp8 control's first tokens at the same
    positions."""
    per_req = sum(g for _, g in cell.lengths())
    good = [i for i, b in enumerate(run.batches) if b.stage_lats is not None]
    order = np.random.default_rng([seed, 2]).permutation(good)
    pick, toks = [], 0
    for i in order:
        if toks >= cell.traffic["check_tokens"]:
            break
        pick.append(int(i))
        toks += per_req * len(run.batches[i].rids)
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    got, ctl = [], []
    try:
        with torch.inference_mode():
            for k, (w, st) in enumerate(zip(ws, cell.stages)):
                prompts = [torch.as_tensor(captured[i][k][0], dtype=torch.long, device=device)
                           for i in pick]
                served = [torch.as_tensor(captured[i][k][1], dtype=torch.long, device=device)
                          for i in pick]
                g, c = ref.stage_gaps(w, st, prompts, served, control)
                got.append(g)
                if control:
                    ctl.append(c)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    out = dict(gap_stats(torch.cat(got, 1)), tokens=toks, batches=len(pick))
    if control:
        out["control"] = gap_stats(torch.cat(ctl, 1))
    return out


def gap_stats(g) -> dict:
    """g: (requests, positions) gaps.  The widest, the mean, and the share
    of served tokens that are not the reference's first choice, with the
    widest gap at each position (the prompt's last, then each decoded)."""
    g = g.float().cpu()
    return {"logit_gap": float(g.max()), "mean_gap": float(g.mean()),
            "off_top_share": float((g > 0).float().mean()),
            "gap_by_position": [round(float(x), 5) for x in g.max(0).values]}


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------
def read_trace(prof, spans: Spans, window_s: float) -> dict:
    """Device busy time (the union of every device operation's interval;
    every one the profiler saw belongs to the window), device time by
    kernel name, and idle seconds by the harness span the host was in."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, names = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        a, d = e.start_ns(), e.duration_ns()
        dev.append((a, a + d))
        names[e.name()] = names.get(e.name(), 0.0) + d * 1e-9
    if not dev:
        return {}
    iv = np.array(sorted(dev), dtype=np.float64)
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.concatenate([[True], iv[1:, 0] > ends[:-1]])
    starts = iv[new, 0]
    stops = np.concatenate([ends[np.flatnonzero(new)[1:] - 1], [ends[-1]]])
    busy = float((stops - starts).sum()) * 1e-9
    ann = [a for a in spans.done if a[2] != "window"]
    win = [a for a in spans.done if a[2] == "window"][0]
    gaps = np.stack([np.concatenate([[win[0]], stops]), np.concatenate([starts, [win[1]]])], 1)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    return {"busy_s": busy, "window_s": window_s, "kernels": names,
            "idle": _label_gaps(gaps, ann, starts, stops)}


def _label_gaps(gaps, ann, starts, stops) -> Dict[str, float]:
    """Idle seconds by the innermost harness span the host was in at each
    gap's middle (nested spans joined by '/'; 'outside' where none).  The
    spans are on the wall clock and the profiler's timestamps should be
    too; where under nine tenths of the busy time falls inside the batches'
    spans, the two clocks disagree and the gaps are left unlabelled."""
    idle = float((gaps[:, 1] - gaps[:, 0]).sum()) * 1e-9
    batches = np.array([a[:2] for a in ann if a[2] == "batch"], dtype=np.float64)
    if not len(batches):
        return {"unlabelled": idle}
    inside = 0.0
    for lo, hi in batches:
        inside += float(np.clip(np.minimum(stops, hi) - np.maximum(starts, lo), 0, None).sum())
    if inside < 0.9 * float((stops - starts).sum()):
        return {"unlabelled": idle}
    bounds = sorted({t for a in ann for t in a[:2]})
    seg = np.array(bounds, dtype=np.float64)
    labels = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        mid = (lo + hi) / 2
        cover = sorted((a for a in ann if a[0] <= mid < a[1]), key=lambda a: a[0])
        labels.append("/".join(a[2] for a in cover) or "outside")
    labels.append("outside")
    mids = (gaps[:, 0] + gaps[:, 1]) / 2
    idx = np.searchsorted(seg, mids, side="right") - 1
    out: Dict[str, float] = {}
    for i, d in zip(idx, (gaps[:, 1] - gaps[:, 0]) * 1e-9):
        lab = labels[i] if i >= 0 else "outside"
        out[lab] = out.get(lab, 0.0) + float(d)
    return out


# ---------------------------------------------------------------------------
def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: Optional[float] = None, cell: Optional[Cell] = None,
        log=print) -> dict:
    """One run; returns the result line's object.  ``cell`` stands in for
    the files of ``workload`` (the tests drive tiny cells on the CPU)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cell or load_cell(workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ws, engine = build(cell, seed, dev)
    warm_up(cell, engine, dev)
    spans = Spans(trace)
    gc.collect()
    gc.disable()
    setup_s = time.perf_counter() - t_start
    try:
        if trace:
            from torch.profiler import ProfilerActivity, profile
            # device activity only: recording every host operation as well
            # would double the host's time a batch, and the host sets it
            for attempt in range(2):     # CUPTI now and then records no kernel
                spans.done.clear()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    run_, captured = run_window(cell, engine, seed, seconds, spans, dev)
                    _sync(dev)
                tr = read_trace(prof, spans, run_.t_end - run_.t0)
                del prof
                if tr:
                    break
                log(f"profiler window {attempt + 1} recorded no device kernel", file=sys.stderr)
        else:
            run_, captured = run_window(cell, engine, seed, seconds, spans, dev)
            tr = {}
    finally:
        gc.enable()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"the process loaded {bad} during the run")
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    got = check(cell, ws, run_, captured, seed, dev)
    failed = sum(r.failed for r in run_.recs)
    checks = {k: {"value": got[k], "limit": lim} for k, lim in cell.traffic["limits"].items()}
    checks["failed_requests"] = {"value": failed, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    ctx = types.SimpleNamespace(cell=cell, run=run_, setup_s=setup_s, seconds=seconds,
                                trace=tr, lengths=cell.lengths())
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(cell.name, kind):
        v = load_metric(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(run_.recs), "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if trace and tr:
        device_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        ops = sorted(tr["kernels"].items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(tr["idle"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k[:120], v] for k, v in ops],
                               "idle_gaps": [[k, v] for k, v in idle]}
    late = [r.pushed - r.due for r in run_.recs if not math.isnan(r.pushed)]
    result["generator_late_s"] = {"max": max(late, default=0.0),
                                  "mean": float(np.mean(late)) if late else 0.0}
    served = [b for b in run_.batches if b.stage_lats]
    result["diag"] = {"batches": len(run_.batches),
                      "mean_batch": float(np.mean([len(b.rids) for b in run_.batches])),
                      "mean_batch_s": float(np.mean([sum(b.stage_lats) for b in served])),
                      "window_s": run_.t_end - run_.t0}
    result["check"] = {k: got[k] for k in ("tokens", "batches", "logit_gap", "mean_gap",
                                           "off_top_share", "gap_by_position")}
    result["checks"] = checks
    for k, v in checks.items():
        log(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    return result
