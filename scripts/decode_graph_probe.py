#!/usr/bin/env python
"""Three probes of the engine's decode step, on a CUDA card.

``steps <cell>``: builds a benchmark cell (``bench/harness.py``), warms it
up (which captures its graphs), serves 12 batches of the cell's batch size
and prompt length under ``repro_torch.tracing.recording()``, and prints,
for each child span of a stage call by its index (``prefill@0``,
``decode@1`` ... ``sync@9``), its median host duration in ms, and the
recording's counters.  A ``decode`` span holds one graph replay, so its
length is the replay's launch plus any wait for room in the card's queue.

``k2``: at phi-3-vision-4.2b's decode shape (4 of its layers, bf16,
prompt 256, 8 steps), for batches 1, 2, 4 and 8, K2's device time a call
(torch.profiler, kernels named ``decode_split``) over 8 eager
``decode_step`` calls and over 8 replays of a ``DecodeGraph``, twice each
in the order eager, graph, eager, graph; prints (calls, mean us, median
us) per run.

``experts <cell> <rows>``: builds a benchmark cell's first stage on its
weights, prefills ``rows`` random prompts of the cell's length and runs
16 eager ``decode_step`` calls under ``repro_torch.tracing.recording()``
(a graph replay counts nothing), four times with new prompts; prints the
MoE counters: ``moe.experts_read / moe.experts`` is the share of the
experts' weights that decode reads.

Run from a checkout's root:

    python3 scripts/decode_graph_probe.py steps jamba-2p.longdoc
    python3 scripts/decode_graph_probe.py k2
    python3 scripts/decode_graph_probe.py experts jamba-2p.chat 6
"""
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 3270000031


def steps(cell_name):
    from bench import harness
    from repro_torch import tracing
    dev = torch.device("cuda")
    cell = harness.load_cell(cell_name)
    _, engine = harness.build(cell, SEED, dev)
    harness.warm_up(cell, engine, dev)
    b, s = cell.traffic["batch_size"], cell.traffic["prompt_tokens"]
    vocab = cell.stages[0]["vocab_size"]
    rng = np.random.default_rng(7)
    with tracing.recording() as rec:
        for _ in range(12):
            engine.serve(rng.integers(0, vocab, (b, s), dtype=np.int32))
    by = {}
    for i, st in enumerate(rec.spans):
        if st.name != "stage":
            continue
        kids = [x for x in rec.spans if x.parent == i]
        for k, x in enumerate(kids):
            by.setdefault(f"{x.name}@{k}", []).append((x.end_ns - x.start_ns) / 1e6)
    print(json.dumps({"cell": cell_name, "b": b,
                      "median_ms_by_child_index": {k: round(float(np.median(t)), 4)
                                                   for k, t in by.items()},
                      "counters": rec.counters}), flush=True)


def k2():
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.serving.decode_graph import DecodeGraph
    cfg = dataclasses.replace(configs.get_config("phi-3-vision-4.2b"), n_layers=4,
                              dtype=torch.bfloat16)
    params = M.init(cfg, seed=0)
    s, n = 256, 8
    cuda = torch.autograd.DeviceType.CUDA
    for b in (1, 2, 4, 8):
        toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (b, s))).cuda()
        res = {}
        with torch.inference_mode():
            hl, caches, _ = M.prefill(params, cfg, {"tokens": toks}, capacity=s + n)
            tok = torch.argmax(hl @ params["embed"].T, dim=-1)[:, None]
            graph = DecodeGraph(params, cfg, caches, torch.cuda.Stream(),
                                torch.cuda.graph_pool_handle())
            for kind in ("eager", "graph", "eager", "graph"):
                graph.load(tok, caches, s)
                c = [{k: t.clone() for k, t in layer.items()} for layer in caches]
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t = tok
                    for i in range(n):
                        if kind == "eager":
                            lg, c = M.decode_step(params, cfg, c, s + i, t)
                            t = torch.argmax(lg, dim=-1)[:, None]
                        else:
                            graph.replay()
                    torch.cuda.synchronize()
                ev = prof.profiler.kineto_results.events()
                us = [(e.end_ns() - e.start_ns()) / 1e3 for e in ev
                      if e.device_type() == cuda and "decode_split" in e.name()]
                res.setdefault(kind, []).append((len(us), round(float(np.mean(us)), 3),
                                                 round(float(np.median(us)), 3)))
        print(json.dumps({"b": b, "k2_calls_mean_median_us": res}), flush=True)


def experts(cell_name, rows):
    from bench import harness, spec, weights
    from repro_torch import tracing
    from repro_torch.models import model as M
    dev = torch.device("cuda")
    cell = harness.load_cell(cell_name)
    st, (s, _) = cell.stages[0], cell.lengths()[0]
    lay = spec.layout(st)
    cfg, params = lay.port_config(st), lay.to_port(weights.make_weights(st, SEED, 0, dev), st)
    rng = np.random.default_rng(11)
    counters = []
    with torch.inference_mode():
        for _ in range(4):
            toks = torch.from_numpy(rng.integers(0, st["vocab_size"], (rows, s))).to(dev)
            hl, caches, _ = M.prefill(params, cfg, {"tokens": toks}, capacity=s + 16)
            tok = torch.argmax(hl @ params["embed"].T, dim=-1)[:, None]
            with tracing.recording() as rec:
                for i in range(16):
                    lg, caches = M.decode_step(params, cfg, caches, s + i, tok)
                    tok = torch.argmax(lg, dim=-1)[:, None]
            counters.append(rec.counters)
    read = sum(c["moe.experts_read"] for c in counters)
    given = sum(c["moe.experts"] for c in counters)
    print(json.dumps({"cell": cell_name, "rows": rows, "steps": 64, "counters": counters,
                      "experts_read_share": read / given}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "steps":
        steps(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "experts":
        experts(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1:] == ["k2"]:
        k2()
    else:
        sys.exit(__doc__)
