"""K1's device time at ``chip_smoke.py``'s prefill shapes, to compare two
trees of the port on one card.

    python3 scripts/k1_times.py [--tree DIR] [--label NAME] [--out FILE]

Imports ``repro_torch`` from ``DIR/src`` (by default this checkout's), so
that a second tree (a ``git archive`` of another commit) builds and times
its own K1.  The shapes are this checkout's ``chip_smoke.K1_ROWS`` and
``K1_MLA_ROW`` (read from its source, so that nothing of this checkout's
program is imported); the MLA row is timed only where the tree's K1 takes
v narrower than q and k.  Each row: bf16, inputs over 128 MB cycled so
every call reads device memory, 30 calls between CUDA events (10 at the
MLA row), the mean in ms.  Prints one JSON line, and appends it to
``--out``.
"""
import argparse
import ast
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONSTANTS = ("BATCH", "PROMPT", "GEN", "NLP_PROMPT", "QWEN_PROMPT", "JAMBA_PROMPT",
             "WHISPER_PROMPT", "K1_ROWS", "K1_MLA_ROW")


def rows():
    """chip_smoke.py's K1 shapes, evaluated from its source."""
    ns = {"math": math}
    for node in ast.parse((ROOT / "chip_smoke.py").read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, (ast.Name, ast.Tuple)) and
                {getattr(n, "id", None) for n in ast.walk(t)} & set(CONSTANTS)
                for t in node.targets):
            exec(compile(ast.Module([node], []), "chip_smoke.py", "exec"), ns)
    return ns["K1_ROWS"], ns["K1_MLA_ROW"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    k1_rows, mla_row = rows()
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch
    from repro_torch.kernels import flash_attention as K1
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)

    def timed(fn, sets, iters):
        for a in sets[:3]:
            fn(*a)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(iters):
            fn(*sets[i % len(sets)])
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / iters

    out = {}
    for label, b, s, sk, h, kv, hd, window, causal in k1_rows:
        q, k, v = randn((b, s, h, hd)), randn((b, sk, kv, hd)), randn((b, sk, kv, hd))
        size = 2 * (q.numel() + k.numel() + v.numel())
        sets = [tuple(t.clone() for t in (q, k, v))
                for _ in range(max(2, min(64, math.ceil((128 << 20) / size))))]
        out[label] = timed(lambda q, k, v: K1.flash_attention(q, k, v, window=window,
                                                               causal=causal), sets, 30)
    label, b, s, h, hd, hd_v, scale = mla_row
    if (hd, hd_v) in getattr(K1, "HEAD_DIM_PAIRS", ()):
        q, k, v = randn((b, s, h, hd)), randn((b, s, h, hd)), randn((b, s, h, hd_v))
        out[label] = timed(lambda q, k, v: K1.flash_attention(q, k, v, scale=scale),
                           [(q, k, v)], 10)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    line = json.dumps({"label": args.label, "tree": args.tree, "card": card, "ms": out})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
