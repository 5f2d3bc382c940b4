"""Training launcher, after ``repro/launch/train.py``.

Trains ``--arch`` (``--reduced`` for the reduced config) on the synthetic
Markov stream with AdamW (warmup ``min(20, steps // 5)``, cosine over
``--steps``) through the naive attention path, as the reference's launcher
does, and prints the loss, the grad norm, the mean step time and the peak
device memory every ``--log-every`` steps.

Run as a plain process it trains on one device.  Under ``torchrun`` (which
sets ``WORLD_SIZE``), or in a process that has initialised a process group
already, it trains on a ``(data, model)`` mesh of ``--data-par`` x
``--model-par`` ranks, one a card (NCCL) or one a CPU process (gloo, with
``--device cpu``): every rank draws the same seeded parameters, keeps its
shards of them under the reference's FSDP specs, the AdamW moments beside
them, and its rows of each batch; rank 0 logs and writes ``--save``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
      --reduced --steps 100 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
      --reduced --steps 10 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --arch qwen2-moe-a2.7b --reduced --data-par 4 --model-par 2
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch import device as D
from repro_torch.distributed import api as dapi
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import convert
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


def param_specs(params, cfg, mesh):
    """The reference's training specs (FSDP) for ``params`` on ``mesh``, in
    the port's per-layer layout (ROADMAP P10)."""
    return convert.specs_from_jax(
        shd.param_specs(convert.param_shapes(params, cfg), mesh, fsdp=True), cfg)


def _value(t) -> float:
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def _join(dev: torch.device):
    """The device and whether this call made the process group, after
    joining the one ``torchrun`` describes where none is initialised."""
    if dist.is_initialized():
        return dev, False
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dev, True


def main(argv=None):
    """Returns (params, opt_state, the metrics of every logged step); on a
    mesh the first two hold DTensors."""
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

    dev = D.resolve(args.device)
    mesh, own_group = None, False
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        dev, own_group = _join(dev)
        mesh = make_local_mesh(args.data_par, args.model_par, dev)
    elif args.data_par * args.model_par != 1:
        raise RuntimeError(f"a {args.data_par}x{args.model_par} mesh needs one process a "
                           f"rank: run under torchrun --nproc-per-node "
                           f"{args.data_par * args.model_par}")
    rank0 = mesh is None or dist.get_rank() == 0
    cfg = configs.get_config(args.arch, reduced=args.reduced)
    ocfg = optim.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                             total_steps=args.steps)
    params = M.init(cfg, seed=0, device=dev)
    if mesh is not None:
        params = shd.distribute(params, mesh, param_specs(params, cfg, mesh))
    opt_state = optim.init_state(params)
    step_fn = make_train_step(cfg, ocfg, impl="naive")
    stream = data.SyntheticStream(
        cfg, data.DataConfig(seq_len=args.seq, batch_size=args.batch))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    it = iter(stream)
    history = []
    try:
        with dapi.use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
            t0 = time.time()
            for i in range(args.steps):
                batch = data.to_device(next(it), dev, mesh)
                params, opt_state, m = step_fn(params, opt_state, batch)
                if i % args.log_every == 0 or i == args.steps - 1:
                    _sync(dev)
                    rec = {k: _value(v) for k, v in m.items()}
                    rec["step"] = i
                    history.append(rec)
                    if rank0:
                        print(f"step {i:5d} loss={rec['loss']:.4f} "
                              f"gnorm={rec['grad_norm']:.3f} "
                              f"({(time.time()-t0)/(i+1):.2f}s/step) {_peak_gib(dev)}",
                              flush=True)
        if args.save:
            checkpoint.save(args.save, params, cfg)
            if rank0:
                print("saved", args.save)
    finally:
        if own_group:
            dist.destroy_process_group()
    return params, opt_state, history


if __name__ == "__main__":
    main()
