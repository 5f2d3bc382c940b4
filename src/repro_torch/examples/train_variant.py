"""Train a ~100M-class model for a few hundred steps -- the counterpart of
the reference's ``examples/train_variant.py``, with the same arguments.

Trains the reduced starcoder2 variant on the synthetic Markov stream with
AdamW + cosine schedule, checkpoints it in the reference's npz format, and
reloads the checkpoint to show the loss is preserved.  (Variant families
for serving are produced exactly like this -- train small/medium/large,
measure accuracy, hand to IPA.)

  PYTHONPATH=src python -m repro_torch.examples.train_variant [--steps 300]
  PYTHONPATH=src python -m repro_torch.examples.train_variant --device cpu
"""
import argparse
import os
import tempfile

import torch

from repro_torch import configs
from repro_torch import device as D
from repro_torch.training import checkpoint, data, optim
from repro_torch.training.train import loss_fn, train_loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    dev = D.resolve(args.device)
    cfg = configs.get_config(args.arch, reduced=True)
    print(f"training reduced {args.arch}: {cfg.n_layers}L d={cfg.d_model} "
          f"({cfg.n_params()/1e6:.1f}M params)")
    stream = data.SyntheticStream(cfg, data.DataConfig(seq_len=128,
                                                       batch_size=8))
    ocfg = optim.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    params, _, hist = train_loop(cfg, stream, steps=args.steps, ocfg=ocfg,
                                 log_every=max(args.steps // 10, 1), device=dev)
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")

    path = os.path.join(tempfile.mkdtemp(), "variant.npz")
    checkpoint.save(path, params, cfg)
    restored = checkpoint.load(path, cfg, device=dev)
    batch = data.to_device(stream.batch(10_000), dev)
    with torch.no_grad():
        l1, _ = loss_fn(params, cfg, batch, impl="naive")
        l2, _ = loss_fn(restored, cfg, batch, impl="naive")
    print(f"checkpoint roundtrip: loss {float(l1):.4f} == {float(l2):.4f}")
    assert abs(float(l1) - float(l2)) < 1e-5
    print("saved variant to", path)


if __name__ == "__main__":
    main()
