"""Dry run of every (architecture x input shape) on the production meshes,
after ``repro/launch/dryrun.py``, as a probe on meta tensors.

The reference lowers and compiles each case for a 256- or 512-chip TPU mesh
and reads XLA's memory and cost analyses.  Here the step runs on ``meta``
tensors, which carry shapes and types and no data, so a full-width case
needs no memory and no device; it runs anywhere:

  * flops: ``torch.utils.flop_counter.FlopCounterMode`` over the step (it
    counts the products: matmuls, batched matmuls and einsums; XLA also
    counts elementwise operations);
  * bytes: a dispatch mode that sums the bytes of every aten operation's
    tensor inputs and outputs, views excepted;
  * both from two probes, one and two pattern blocks deep, extrapolated to
    the full depth as the reference's ``probe_costs`` does.

The counts are of the unpartitioned program, divided by the mesh's device
count: an ideal partition.  The reference's are of the partitioned program
that XLA compiled.  There is no partitioned program to read collectives
from (the reference parses XLA's HLO in ``collective_bytes``), so
``collective_bytes_per_dev`` and ``collective_s`` are None.

Memory: ``mem.argument_gb`` and ``mem.output_gb`` are the per-device bytes
of the step's arguments and outputs under the sharding specs of
``repro_torch.distributed.sharding``: each leaf's bytes over the product
of the mesh axes that shard it (parameters, AdamW moments, the batch and
the decode caches).  ``temp_gb`` is None: there is no compiler to ask.

The roofline terms divide by NVIDIA's data-sheet peaks of one H100 SXM at
its 700 W power limit (not a measurement): 989 TFLOP/s of dense bf16 and
3.35 TB/s of HBM3.  The byte count is of the eager, unfused program (f32
softmax, K and V repeated over each head group): many times the traffic of
a fused step.  So its term is ``counted_memory_s`` and the larger of the
two terms ``counted_bottleneck``, not the reference's ``memory_s`` and
``bottleneck``, which read the compiled program.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models import stack as ST
from repro_torch.training import optim
from repro_torch.training import train as TT
from repro_torch.training.data import input_specs

# --- H100 SXM, NVIDIA data sheet, 700 W (roofline) --------------------------
PEAK_FLOPS = 989e12          # dense bf16 tensor cores, FLOP/s
HBM_BW = 3.35e12             # bytes/s
# A collective term would divide by NVLink 4's 450 GB/s each way per card;
# without a partitioned program there are no collective bytes to divide.
COLLECTIVE_NOTE = ("no partitioned program: the reference reads collectives "
                   "from XLA's HLO, which a meta-tensor probe does not have")
_VIEWS = {torch.ops.aten._unsafe_view.default}


def serving_fsdp(cfg: ModelConfig, mesh) -> bool:
    """Shard serving weights over data too when TP-only exceeds ~8 GB/chip."""
    model_sz = mesh.shape.get("model", 1)
    return cfg.n_params() * 2 / model_sz > 8e9


def _weights(cfg, mesh, weights_mode):
    """-> (fsdp, expert_mode) for serving param specs."""
    if weights_mode == "auto":
        return serving_fsdp(cfg, mesh), "none"
    if weights_mode == "tp":
        return False, "none"
    if weights_mode == "fsdp":
        return True, "none"
    if weights_mode == "expert2d":
        return True, "hidden_data"
    if weights_mode == "expertff":
        return False, "hidden_model"
    raise ValueError(weights_mode)


@dataclasses.dataclass
class Case:
    """One step and its arguments: ``fn(*args)`` runs it; ``arg_shapes`` and
    ``out_shapes`` are the arguments and outputs in the reference's stacked
    layout (meta tensors), ``arg_specs`` and ``out_specs`` their sharding
    specs, tree for tree."""
    fn: object
    args: tuple
    arg_shapes: tuple
    arg_specs: tuple
    out_shapes: tuple
    out_specs: tuple


def _inputs(cfg, shape: InputShape, kind: str, device: torch.device):
    specs = input_specs(cfg, shape.seq_len, shape.global_batch, kind, dtype=cfg.dtype)
    if device.type == "meta":
        return specs
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device) for k, v in specs.items()}


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def build_case(cfg: ModelConfig, shape: InputShape, mesh, *,
               moe_impl: str = "einsum", weights_mode: str = "auto",
               microbatch: int = 1, impl: str = "chunked",
               device="meta") -> Case:
    """The step of ``shape.kind`` on ``device`` (meta: shapes only; a real
    device gets seeded parameters and zero inputs and caches): train is the
    chunked forward with per-layer remat, cross-entropy, backward and AdamW
    (``microbatch`` > 1 accumulates f32 gradients over that many slices of
    the batch); prefill ``model.prefill``; decode one ``decode_step`` with
    every slot of a cache of ``seq_len`` (+ the VLM prefix) valid.  ``impl``
    is the attention path of prefill and decode."""
    device = torch.device(device)
    ax = shd.MeshAxes.of(mesh)
    batch_dim = shape.global_batch
    bdim = shd._fit(mesh, batch_dim, ax.data)
    params = M.init(cfg, seed=0, device=device)
    params_shape = convert.param_shapes(params, cfg)

    def bspecs(batch):
        return {k: shd.P(bdim, *([None] * (v.dim() - 1))) for k, v in batch.items()}

    if shape.kind == "train":
        ocfg = optim.AdamWConfig()
        opt_state = optim.init_state(params)
        f32 = lambda t: _meta(t.shape, torch.float32)  # noqa: E731
        opt_shape = {"mu": optim.tree_map(f32, params_shape),
                     "nu": optim.tree_map(f32, params_shape),
                     "step": _meta((), torch.int32)}
        batch = _inputs(cfg, shape, "train", device)

        def step(params, opt_state, batch):
            leaves = optim.tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            try:
                n = batch_dim // microbatch
                grads, total = None, 0.0
                for i in range(microbatch):
                    one = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                    loss, parts = TT.loss_fn(params, cfg, one, impl="chunked",
                                             moe_impl=moe_impl, remat=True)
                    g = torch.autograd.grad(loss, leaves, materialize_grads=True)
                    total = total + loss.detach()
                    if microbatch == 1:
                        grads = g
                    else:   # the reference accumulates from f32 zeros
                        grads = [x.float() if grads is None else grads[j] + x
                                 for j, x in enumerate(g)]
            finally:
                for p in leaves:
                    p.requires_grad_(False)
            if microbatch > 1:
                grads = [g / microbatch for g in grads]
            flat = iter(grads)
            grads = optim.tree_map(lambda _: next(flat), params)
            params, opt_state, om = optim.apply_updates(
                params, grads, opt_state, ocfg, decay=TT.decay_mask(params, cfg))
            loss = total / microbatch
            if microbatch > 1:
                parts = {"ce": loss, "aux": torch.zeros_like(loss)}
            return params, opt_state, {"loss": loss, **parts, **om}

        pspec = shd.param_specs(params_shape, mesh, fsdp=True)
        ospec = {"mu": pspec, "nu": pspec, "step": shd.P()}
        bshape = {k: _meta(v.shape, v.dtype) for k, v in batch.items()}
        # loss, ce, aux, grad_norm, lr: f32 scalars
        metrics = {k: _meta((), torch.float32) for k in ("loss", "ce", "aux", "grad_norm", "lr")}
        return Case(step, (params, opt_state, batch),
                    (params_shape, opt_shape, bshape), (pspec, ospec, bspecs(bshape)),
                    (params_shape, opt_shape, metrics),
                    (pspec, ospec, {k: shd.P() for k in metrics}))
    fsdp, e2d = _weights(cfg, mesh, weights_mode)
    pspec = shd.param_specs(params_shape, mesh, fsdp=fsdp, expert_mode=e2d)
    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    cache_shape = convert.cache_shapes(
        M.init_cache(cfg, batch_dim, shape.seq_len + prefix, device="meta"), cfg)
    cspec = shd.cache_specs(cfg, shape, mesh, cache_shape)
    if shape.kind == "prefill":
        batch = _inputs(cfg, shape, "prefill", device)
        bshape = {k: _meta(v.shape, v.dtype) for k, v in batch.items()}

        def fn(params, batch):
            hl, caches, _ = M.prefill(params, cfg, batch, impl=impl, moe_impl=moe_impl)
            return hl, caches

        hidden = _meta((batch_dim, cfg.d_model), cfg.dtype)
        return Case(fn, (params, batch), (params_shape, bshape), (pspec, bspecs(bshape)),
                    (hidden, cache_shape), (shd.P(bdim, None), cspec))
    if shape.kind == "decode":
        caches = M.init_cache(cfg, batch_dim, shape.seq_len + prefix, device=device)
        tokens = _inputs(cfg, shape, "decode", device)["tokens"]
        cache_len = shape.seq_len + prefix - 1

        def fn(params, caches, tokens):
            return M.decode_step(params, cfg, caches, cache_len, tokens, impl=impl,
                                 moe_impl=moe_impl)

        tshape = _meta(tokens.shape, tokens.dtype)
        # the reference passes the position as an int32 scalar argument
        pos = _meta((), torch.int32)
        logits = _meta((batch_dim, cfg.vocab), cfg.dtype)
        return Case(fn, (params, caches, tokens),
                    (params_shape, cache_shape, pos, tshape),
                    (pspec, cspec, shd.P(), shd.P(bdim, None)),
                    (logits, cache_shape), (shd.P(bdim, None), cspec))
    raise ValueError(shape.kind)


def sharded_bytes(shapes, specs, mesh) -> int:
    """Per-device bytes of a tree of meta tensors under its spec tree: each
    leaf's bytes over the product of the mesh axes its spec names."""
    total = 0

    def one(path, leaf):
        nonlocal total
        spec = _leaf_at(specs, path)
        div = 1
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                div *= mesh.shape[a]
        total += leaf.numel() * leaf.element_size() // div

    shd.map_with_path(one, shapes)
    return total


def _leaf_at(tree, path: str):
    for key in path.split("/") if path else ():
        tree = tree[key] if isinstance(tree, dict) else tree[int(key)]
    return tree


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of the tensor inputs and outputs of every aten
    operation dispatched under it, views excepted (they move nothing)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func in _VIEWS):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def count(case: Case):
    """(flops, bytes) of one run of ``case.fn`` on its arguments."""
    flops = FlopCounterMode(display=False)
    nbytes = ByteCounter()
    with flops, nbytes:
        case.fn(*case.args)
    return float(flops.get_total_flops()), float(nbytes.bytes)


def model_flops_per_device(cfg: ModelConfig, shape: InputShape,
                           n_devices: int) -> float:
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens / n_devices
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens / n_devices
    return 2.0 * n * shape.global_batch / n_devices   # decode: 1 tok/seq


def _probe_cfg(cfg: ModelConfig, k: int) -> ModelConfig:
    """k-block-deep clone of cfg (same pattern period + remainder)."""
    pl = ST.plan(cfg, cross=(cfg.family == "encdec"))
    changes = {"n_layers": k * pl.period + len(pl.rem)}
    if cfg.family == "encdec":
        changes["n_encoder_layers"] = k
    return dataclasses.replace(cfg, **changes)


def probe_costs(cfg: ModelConfig, shape: InputShape, mesh, *,
                moe_impl: str = "einsum", weights_mode: str = "auto",
                microbatch: int = 1):
    """Per-device flops and bytes from two probes (k=1, k=2 blocks).

    cost(k) is affine in k for a homogeneous stack, so
      total(n_rep) = cost(1) + (n_rep - 1) * (cost(2) - cost(1)),
    as the reference extrapolates its unrolled probes.  Counts are of the
    unpartitioned program over the mesh's device count."""
    pl_full = ST.plan(cfg, cross=(cfg.family == "encdec"))
    n_dev = mesh.size
    res = {}
    for k in (1, 2):
        case = build_case(_probe_cfg(cfg, k), shape, mesh, moe_impl=moe_impl,
                          weights_mode=weights_mode, microbatch=microbatch)
        flops, nbytes = count(case)
        res[k] = {"flops": flops / n_dev, "bytes": nbytes / n_dev}
    n_rep = pl_full.n_rep

    def extrap(a, b):
        return max(a + (n_rep - 1) * (b - a), 0.0)

    return {"flops": extrap(res[1]["flops"], res[2]["flops"]),
            "bytes": extrap(res[1]["bytes"], res[2]["bytes"]),
            "probe_raw": res, "n_rep": n_rep}


def make_custom_mesh(spec: str) -> MeshShape:
    """'32x8' -> a (data=32, model=8) mesh shape."""
    d, m = (int(x) for x in spec.split("x"))
    return MeshShape(("data", "model"), (d, m))


def run_case(arch: str, shape_name: str, *, multi_pod: bool = False,
             moe_impl: str = "einsum", verbose: bool = True,
             mesh_shape: Optional[str] = None, weights_mode: str = "auto",
             microbatch: int = 1, cfg: Optional[ModelConfig] = None) -> Dict:
    """One case's record; ``cfg`` replaces ``arch``'s published config (a
    reduced one, say).  A failure is caught and recorded (``ok`` false,
    ``error``, ``traceback``), as in the reference's sweep."""
    cfg = cfg or configs.get_config(arch)
    shape = configs.INPUT_SHAPES[shape_name]
    mesh = (make_custom_mesh(mesh_shape) if mesh_shape
            else make_production_mesh(multi_pod=multi_pod))
    n_dev = mesh.size
    rec = {"arch": arch, "shape": shape.name, "mesh": "x".join(
        f"{k}={v}" for k, v in mesh.shape.items()), "devices": n_dev,
        "moe_impl": moe_impl, "weights_mode": weights_mode, "ok": False}
    t0 = time.time()
    try:
        case = build_case(cfg, shape, mesh, moe_impl=moe_impl, weights_mode=weights_mode,
                          microbatch=microbatch)
        probe = probe_costs(cfg, shape, mesh, moe_impl=moe_impl,
                            weights_mode=weights_mode, microbatch=microbatch)
        flops, bytes_acc = probe["flops"], probe["bytes"]
        mflops = model_flops_per_device(cfg, shape, n_dev)
        rec.update({
            "ok": True,
            "params": cfg.n_params(),
            "counted_flops_per_dev": flops,
            "counted_bytes_per_dev": bytes_acc,
            "collective_bytes_per_dev": None,
            "probe": {"n_rep": probe["n_rep"], "raw": probe["probe_raw"]},
            "mem": {
                "argument_gb": sharded_bytes(case.arg_shapes, case.arg_specs, mesh) / 2**30,
                "output_gb": sharded_bytes(case.out_shapes, case.out_specs, mesh) / 2**30,
                "temp_gb": None,
            },
            "model_flops_per_dev": mflops,
            "compute_s": flops / PEAK_FLOPS,
            "counted_memory_s": bytes_acc / HBM_BW,
            "collective_s": None,
            "collective_note": COLLECTIVE_NOTE,
            "peaks": "H100 SXM data sheet at 700 W: 989e12 bf16 FLOP/s, 3.35e12 B/s",
            "useful_flops_ratio": mflops / flops if flops else 0.0,
        })
        terms = {"compute": rec["compute_s"], "memory": rec["counted_memory_s"]}
        rec["counted_bottleneck"] = max(terms, key=terms.get)
        if verbose:
            print(rec["mem"], {k: f"{v:.3e}" for k, v in terms.items()},
                  "->", rec["counted_bottleneck"], f"useful={rec['useful_flops_ratio']:.3f}")
    except Exception as e:  # noqa: BLE001 -- report, don't die mid-sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print("FAILED:", rec["error"])
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None) -> int:
    """Returns 0 when every case is ok, else 1."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--moe-impl", default="einsum")
    ap.add_argument("--mesh-shape", default=None,
                    help="override mesh, e.g. 32x8")
    ap.add_argument("--weights-mode", default="auto",
                    choices=["auto", "tp", "fsdp", "expert2d", "expertff"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    pairs = (configs.all_dryrun_pairs() if args.all
             else [(args.arch, configs.INPUT_SHAPES[args.shape])])
    tag = "multipod" if args.multi_pod else "singlepod"
    if args.mesh_shape:
        tag = f"mesh{args.mesh_shape}"
    if args.weights_mode != "auto":
        tag += f"__{args.weights_mode}"
    if args.microbatch > 1:
        tag += f"__mb{args.microbatch}"
    n_ok = 0
    for arch, shape in pairs:
        sname = shape.name
        path = os.path.join(args.out,
                            f"{arch}__{sname}__{tag}__{args.moe_impl}.json")
        if args.skip_existing and os.path.exists(path):
            print(f"skip {arch} x {sname} ({tag})")
            n_ok += 1
            continue
        print(f"=== {arch} x {sname} ({tag}, moe={args.moe_impl}) ===",
              flush=True)
        rec = run_case(arch, sname, multi_pod=args.multi_pod,
                       moe_impl=args.moe_impl, mesh_shape=args.mesh_shape,
                       weights_mode=args.weights_mode,
                       microbatch=args.microbatch)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        n_ok += int(rec["ok"])
        print(f"    -> ok={rec['ok']} total={rec['total_s']}s", flush=True)
    print(f"dry-run complete: {n_ok}/{len(pairs)} ok")
    return 0 if n_ok == len(pairs) else 1


if __name__ == "__main__":
    sys.exit(main())
