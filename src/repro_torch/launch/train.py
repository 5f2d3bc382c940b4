"""Training launcher, after ``repro/launch/train.py``, on one device.

Trains ``--arch`` (``--reduced`` for the reduced config) on the synthetic
Markov stream with AdamW (warmup ``min(20, steps // 5)``, cosine over
``--steps``) through the naive attention path, as the reference's launcher
does, and prints the loss, the grad norm, the mean step time and the peak
device memory every ``--log-every`` steps.  One card has no mesh: a
``--data-par`` or ``--model-par`` other than 1 raises (ROADMAP item 13).

  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
      --reduced --steps 100 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
      --reduced --steps 10 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch import device as D
from repro_torch.models import model as M
from repro_torch.training import checkpoint, data, optim
from repro_torch.training.train import make_train_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gib(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "peak mem not measured (cpu)"
    return f"peak mem {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"


def main(argv=None):
    """Returns (params, opt_state, the metrics of every logged step)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_IDS))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--save", default=None, help="npz checkpoint path")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    if args.data_par != 1 or args.model_par != 1:
        raise NotImplementedError(
            "--data-par/--model-par: one device has no mesh; sharded training "
            "comes with ROADMAP item 13")
    dev = D.resolve(args.device)
    cfg = configs.get_config(args.arch, reduced=args.reduced)
    ocfg = optim.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                             total_steps=args.steps)
    params = M.init(cfg, seed=0, device=dev)
    opt_state = optim.init_state(params)
    step_fn = make_train_step(cfg, ocfg, impl="naive")
    stream = data.SyntheticStream(
        cfg, data.DataConfig(seq_len=args.seq, batch_size=args.batch))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    it = iter(stream)
    history = []
    t0 = time.time()
    for i in range(args.steps):
        batch = data.to_device(next(it), dev)
        params, opt_state, m = step_fn(params, opt_state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            _sync(dev)
            rec = {k: float(v) for k, v in m.items()}
            rec["step"] = i
            history.append(rec)
            print(f"step {i:5d} loss={rec['loss']:.4f} "
                  f"gnorm={rec['grad_norm']:.3f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step) {_peak_gib(dev)}", flush=True)
    if args.save:
        checkpoint.save(args.save, params, cfg)
        print("saved", args.save)
    return params, opt_state, history


if __name__ == "__main__":
    main()
