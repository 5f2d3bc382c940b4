"""Where a MoE cell's widest logit gaps come from: the program's routing
against the plain reference's, layer by layer, and the reference fed the
program's routing.  The benchmark's runs do not run this.

    python3 bench/routing.py --workload jamba-2p.longdoc --seeds 21,22,23 [--batches 2]

For each seed, in one process: the cell's pipeline built from that seed and
warmed up as in a run, then ``--batches`` full batches of the cell's
prompts served through ``PipelineEngine.serve``, with the top-k experts of
every MoE layer recorded as the program picks them
(``repro_torch.models.moe._route``).  With the engine freed, the reference
reruns each batch's prompt with its served tokens twice: with its own
routing, recording its choices, and with every routing group's experts
taken from the program's record (the reference's own router weights at
those experts, its own capacity rule).  Prints, for each seed and MoE
layer, the share of tokens whose top-k set differs between the two sides
in the prefill and in the decode steps, and the tokens that routed alike
but lost an expert to capacity on one side only; then the gap statistics
of the served tokens under both reference runs.  Writes
``<out>/routing_<name>.json`` (``--out``, by default ``results/bench``).
"""
import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _plan(st, rows, prompt_len, n_out):
    """The reference's routing groups in the order it routes them: each
    MoE layer, each segment (the prompt, then each decoded position), each
    group of the segment's tokens; as (layer, segment, first row, rows)."""
    from bench.layouts import decoder
    gs = st["moe_group_size"]
    moe_layers = [i for i in range(st["num_hidden_layers"]) if decoder.is_moe(st, i)]
    out = []
    for m in range(len(moe_layers)):
        for j, n in enumerate([rows * prompt_len] + [rows] * (n_out - 1)):
            tg = min(gs, n)
            if n % tg:
                tg = n
            out += [(m, j, a, tg) for a in range(0, n, tg)]
    return len(moe_layers), out


def compare(cell, seed: int, batches: int, device) -> dict:
    """One seed: see the module's docstring."""
    import numpy as np
    import torch
    from bench import harness
    from bench.reference import decoder as ref
    from bench.reference.model import gaps
    from repro_torch.models import moe as MO

    (st,) = cell.stages
    (prompt_len, gen), = cell.lengths()
    ws, engine = harness.build(cell, seed, device)
    harness.warm_up(cell, engine, device)
    prompt = harness.prompt_maker(cell, seed)
    b = cell.traffic["batch_size"]
    record, real_route = [], MO._route

    def route(params, xf, mcfg):
        top_w, top_i, aux = real_route(params, xf, mcfg)
        record[-1].append(top_i.reshape(-1, top_i.shape[-1]).cpu())
        return top_w, top_i, aux

    served = []
    MO._route = route
    try:
        for n in range(batches):
            toks = np.stack([prompt(n * b + i) for i in range(b)])
            record.append([])
            out, _ = engine.serve(toks)
            served.append((toks, out))
    finally:
        MO._route = real_route
    del engine
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    n_moe, plan = _plan(st, b, prompt_len, gen)
    layers = [{"prefill_flip": 0, "decode_flip": 0, "first_flip": 0, "drop_only": 0}
              for _ in range(n_moe)]
    own_g, forced_g = [], []
    real_top_k = ref._top_k
    with torch.inference_mode():
        for (toks, out), prog in zip(served, record):
            # the program's record: the prefill's n_moe calls, then each
            # decode step's; its last decode step feeds no served token
            prog_by = {(m, j): prog[j * n_moe + m] for m in range(n_moe) for j in range(gen)}
            batch = torch.cat([torch.as_tensor(toks), torch.as_tensor(out[:, :-1])], 1)
            batch = batch.long().to(device)
            chosen = torch.as_tensor(out).long().to(device)
            mine, calls = [], iter(plan)

            def own(probs, k):
                top_w, top_i = real_top_k(probs, k)
                mine.append(top_i.cpu())
                return top_w, top_i

            def forced(probs, k):
                m, j, a, tg = next(calls)
                top_i = prog_by[(m, j)][a:a + tg].to(probs.device)
                return probs.gather(-1, top_i), top_i

            for fn, sink in ((own, own_g), (forced, forced_g)):
                ref._top_k = fn
                try:
                    (lg,) = ref.forward(ws[0], st, [batch], prompt_len, gen)
                finally:
                    ref._top_k = real_top_k
                sink.append(gaps(lg, chosen))
            assert len(mine) == len(plan), (len(mine), len(plan))
            for (m, j, a, tg), r in zip(plan, mine):
                p = prog_by[(m, j)][a:a + tg]
                same = (p.sort(-1).values == r.sort(-1).values).all(-1)
                layers[m]["prefill_flip" if j == 0 else "decode_flip"] += int((~same).sum())
                layers[m]["first_flip"] += int((p[:, 0] != r[:, 0]).sum())
                kp = torch.zeros(tg, st["num_experts"], dtype=torch.bool)
                kr = kp.clone()
                kp.scatter_(1, p, ref.kept(p, st))
                kr.scatter_(1, r, ref.kept(r, st))
                layers[m]["drop_only"] += int((same & (kp != kr).any(-1)).sum())
    tokens = {"prefill": batches * b * prompt_len, "decode": batches * b * (gen - 1)}
    for d in layers:
        d["prefill_flip_share"] = d["prefill_flip"] / tokens["prefill"]
        d["decode_flip_share"] = d["decode_flip"] / tokens["decode"]
    return {"seed": seed, "tokens": tokens, "layers": layers,
            "own_routing": harness.gap_stats(torch.cat(own_g)),
            "program_routing": harness.gap_stats(torch.cat(forced_g))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "results" / "bench"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = compare(cell, seed, args.batches, torch.device("cuda"))
        rows.append(row)
        print(json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / f"routing_{args.workload}.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
