#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA H100.

  python3 chip_smoke.py

Phases, each of which fails the script if it fails:

1. device: require CUDA, print the card's name and power limit, turn TF32 off;
2. build the three CUDA libraries from src/repro_torch/kernels/csrc, all at
   once, and print each kernel's registers and spills (ptxas), each
   library's tensor-core instructions (HMMA / HGMMA in cuobjdump -sass;
   K1's and K3's must be nonzero), and each kernel's dynamic shared memory
   and resident blocks per SM (the bf16 paths of K1 and K3 must reach two;
   K2's splits, ring stages and blocks at the decode shapes, which must
   fit in one wave);
3. hold each kernel against its plain PyTorch version on the card at the
   serving paths' shapes (nlp-chain's and jamba's included) and at the
   edges of the bf16 kernels' tiles and
   of K2's splits (attention: bf16 within 2e-2, f32 within 2e-4; the SSD
   scan: y within 2e-2 in bf16, the state and f32 y within atol 5e-4 /
   rtol 5e-3, and at mamba2-2.7b's widths at most 2e-4 of the bf16 y
   rounded to another bf16 value than the plain version's), and K2 called
   again and again at alternating shapes (its arrival counters must be
   zero after), then
   time the bf16 kernel, the f32 kernel, the plain version and, for
   attention, F.scaled_dot_product_attention (a yardstick the port never
   calls) with CUDA events, beside the card's bound, list the device
   kernels one call launches with their device time (torch.profiler), and
   time K2 at other split counts than its wrapper's;
4. serve the vlm-classify pipeline at full width -- phi-3-vision-4.2b at its
   published config, then yi-34b at full width with its depth cut to 12 of
   60 layers -- with random weights from a seed, counting kernel launches
   on the device (a profiler trace: the decode steps replay CUDA graphs),
   and hold one stage's kernel path against its naive attention path;
5. profile the reduced vlm-classify variant families exactly as
   ``build_pipeline`` does, and the full-width phi-3 stage, into StageModels,
   and hand the profiled vlm-classify PipelineModel to the port's planner:
   ``solve_vec`` and ``solve_brute`` must pick the same config, objective,
   PAS, cost and latency at 1, 16 and 256 requests/s, printed beside
   ``fa2_low``'s and ``rim``'s picks (one card measures one replica only;
   more are modelled as l / R^0.75);
6. serve mamba2-2.7b at its published config (64 layers, d 2560) as a
   one-stage pipeline, counting SSD scan launches, trace a batch, hold its
   kernel path against its naive SSD path at S 1024 and S 1000 (in bf16:
   both against an exact evaluation of the scan, the kernel path no farther
   from it than the naive path), and profile the reduced mamba2 family and
   the full-width stage;
7. serve nlp-chain at full width -- gemma3-27b with its depth cut to 24 of
   62 layers (window 1024, a 1280-token prompt, so every local layer's ring
   wraps), qwen2-moe-a2.7b and mamba2-2.7b at their published configs --
   counting the launches of all three kernels, trace a batch, split the
   MoE layers' device time by kernel name, hold gemma3's and qwen2-moe's
   kernel paths against their naive paths and qwen2-moe's einsum dispatch
   against its gather dispatch (bf16 greedy tokens on the served weights,
   qwen2-moe's second run under the first run's MoE routing; f32 logits
   within 2e-4 at a cut depth, every token routed alike in both runs),
   time one qwen2-moe MoE layer in each dispatch mode, and profile the
   reduced nlp-chain families through ``build_pipeline``;
8. serve jamba-v0.1-52b at full width with its depth cut to one period of
   8 layers (attention, MoE and Mamba2 with d_state 16), counting launches,
   and hold its kernel path against its naive path in bf16 (under the naive
   path's MoE routing) and in f32 (every token routed alike);
9. replay IPA's loop on the card-profiled vlm-classify pipeline of phase 5:
   ``repro_torch.launch.serve.replay`` under all four policies on the
   launcher's defaults (bursty, 120 s, x 0.25, alpha 10, beta 0.5, seed 0),
   logging the end-to-end metrics; a second ``ipa`` replay must give the
   same summary and ``replay`` what ``run_trace`` gives on the same inputs;
   then the launcher's ``main`` itself (``--seconds 60``), which profiles
   anew;
10. serve whisper-medium at its published config, all 24 encoder and 24
   decoder layers (B 4, 1500 frames, a 32-token prompt, 8 greedy tokens
   through ``prefill`` and ``decode_step``): K1 over the frames in every
   encoder layer, over the prompt in every decoder layer and with Sq != Sk
   (the prompt over the frames) in every cross-attention prefill, K2 over
   the self cache and over the frames in every decode step, counting
   launches, tracing a batch, and holding the kernel path against the naive
   path: f32 logits within 2e-4; in bf16 both against an f32 evaluation of
   the same weights, the kernel path's mean distance at most 1.1 times the
   naive path's and its greedy tokens the f32 evaluation's where the margin
   exceeds twice the naive path's own largest distance.  The engine cannot
   serve whisper (ROADMAP R2);
11. enum (after phase 5's planner): ``solve_enum``, the float32 torch
   enumeration, on the card must pick what ``solve_vec`` and
   ``solve_brute`` pick at 1, 16 and 256 requests/s;
12. predictor (after phase 9's replay): the LSTM's forward on the card
   against the CPU (within 1e-5), its training on the 14-day train region
   (400 steps, stride 30), timed, its SMAPE on the test region (below 15,
   and at most persistence + 1), then Fig. 16's ablation (``run_trace``
   under ``ipa`` with reactive, LSTM and oracle demand) on the paper's
   video pipeline and on the card-profiled vlm-classify pipeline;
13. train: starcoder2-3b at its published config through the
   training launcher (``launch.train.main``, 5 steps at B 8, S 128, naive
   attention), each step's loss and grad norm finite, then its step time,
   tokens/s, peak memory and the optimizer's share of the step's device
   time (torch.profiler); one reduced f32 step on the card against the CPU
   (loss and gradients within 2e-4); the reference's learning check (120
   steps of reduced starcoder2-3b, the loss down by more than 0.2); and
   each kernel refusing inputs that require grad, before launching;
14. mesh: an NCCL process group of one rank in this process and the 1x1
   ``DeviceMesh`` over it; the launcher's mesh path (DTensor parameters,
   moments and batches, the models' ``constrain``) on starcoder2-3b with
   phase 13's arguments, each step's loss and grad norm within 2e-2
   (relative) of phase 13's, its step time, tokens/s and peak memory beside
   phase 13's; a checkpoint saved from the mesh and loaded back onto it,
   every leaf equal bit for bit; the group destroyed after; then, on the
   host's CPU, reduced jamba's train step on a 2x2 mesh of four gloo
   processes against the unsharded step, within 2e-4
   (``tests/test_torch_mesh_ranks.py``'s slow test): what the installed
   torch refuses only on several ranks (ROADMAP P11), which one rank
   cannot show;
15. dryrun (last): the port's dry run (``repro_torch.launch.dryrun``'s
   ``main`` with ``--all``, on meta tensors, after the timed phases, its
   cases in a process a CPU) over every architecture x input shape
   pair on the 16x16 production mesh, all 35 ok, each record with its
   collective bytes and time (DTensor on a fake process group), yi-34b's
   decode_32k and train_4k collectives printed by kind; yi-34b x decode_32k's 1- and 2-block probes
   (B 128, a 32768-slot cache, full width) built for real on the card and
   run with K2 over every slot: the allocator's bytes for their arguments
   against the dry run's count, the step's peak over them, and the device
   time a block beside the dry run's counted_memory_s for one block; then the
   ``adaptability`` example on the card, line for line as on the CPU, and
   ``quickstart``.  Phase 3 also times K2 at that probe's shape.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.core import baselines as BL  # noqa: E402
from repro_torch.core import optimizer as OPT  # noqa: E402
from repro_torch.core import profiler as PF  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as K2  # noqa: E402
from repro_torch.kernels import flash_attention as K1  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as K3  # noqa: E402
from repro_torch.core import adapter as AD  # noqa: E402
from repro_torch.core import paper_profiles as PP  # noqa: E402
from repro_torch.core import predictor as PR  # noqa: E402
from repro_torch.core import trace as TR  # noqa: E402
from repro_torch.distributed import api as dapi  # noqa: E402
from repro_torch.examples import adaptability, quickstart  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.launch.serve import build_pipeline  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import layers as ML  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MO  # noqa: E402
from repro_torch.serving.engine import PipelineEngine, StageServer  # noqa: E402
from repro_torch.training import checkpoint as CK  # noqa: E402
from repro_torch.training import data as TD  # noqa: E402
from repro_torch.training import optim as OT  # noqa: E402
from repro_torch.training import train as TT  # noqa: E402

TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}    # tests/test_kernels.py:13-15
# the SSD scan sums its decays in another order than the plain version's
# cumsum: the reference's own SSD tolerance in f32 (tests/test_kernels.py:90-93)
SSD_TOL = {torch.bfloat16: dict(atol=2e-2, rtol=2e-2),
           torch.float32: dict(atol=5e-4, rtol=5e-3)}
MAMBA_TOL = dict(atol=1e-3, rtol=1e-2)    # tests/test_kernels.py:143-146
# The bf16 SSD kernel takes each f32 operand of its products as three bf16
# terms, so its y rounds to bf16 almost as the f32 plain version's does: at
# mamba2-2.7b's widths 5e-5 to 8e-5 of the outputs round to another bf16
# value (H100).  Two terms, which still hold the 2e-2 tolerance, give 6e-4.
SSD_ROUNDING_SHARE = 2e-4
# H100 SXM peaks (NVIDIA data sheet, dense, at its 700 W power limit): bf16
# tensor cores, f32 CUDA cores (the kernels use no TF32), HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
BATCH, PROMPT, GEN = 4, 256, 8
YI_LAYERS = 12
MAMBA_PROMPT = 1024
# nlp-chain: gemma3-27b at full width with 24 of its 62 layers (21.1 GiB of
# bf16 weights; all 62, 50.3 GiB, do not fit beside qwen2-moe's 26.1 and
# mamba2's 5.0), four of them global (5, 11, 17, 23); a prompt past its
# 1024-slot window, so every local layer's ring wraps in prefill and decode
GEMMA_LAYERS = 24
NLP_PROMPT = 1280
# kernel vs naive on qwen2-moe: T = 4 x 256 = 1024 tokens, one routing group
# of capacity 86 an expert; the f32 checks' depth cuts (one gemma3 period,
# global layer 5 included)
QWEN_PROMPT = 256
GEMMA_F32_LAYERS, QWEN_F32_LAYERS = 6, 4
# jamba-v0.1-52b at full width, one period of its 32 layers (24.2 GiB):
# attention at layer 4, MoE at 1, 3, 5 and 7, Mamba2 (d_state 16) elsewhere
JAMBA_LAYERS = 8
JAMBA_PROMPT = 256
# whisper-medium at its published config: 1500 frames, a 32-token prompt.
# Its bf16 kernel path's mean logit distance from an f32 evaluation of the
# same weights may be at most this many times the naive path's (on an H100
# the two agree within 0.1%; a kernel fault moves every position it
# touches)
WHISPER_PROMPT = 32
WHISPER_MEAN_RATIO = 1.1
DEV = "cuda"
# the planner phase: request rates, and the objective of the serving launcher's
# defaults (--alpha 10 --beta 0.5, src/repro/launch/serve.py)
PLANNER_RPS = (1.0, 16.0, 256.0)
PLANNER_OBJ = dict(alpha=10.0, beta=0.5, metric="pas")
# K2 at the first decode step of each stage (cache_len = prompt, so lengths
# = prompt + 1 of capacity prompt + GEN), a full yi-34b cache of 520 slots,
# gemma3's wrapped 1024-slot ring of a local layer and its global cache,
# qwen2-moe's and jamba's: (label, H, KV, hd, L, lengths)
DECODE_SHAPES = (("phi-3 decode", 32, 32, 96, PROMPT + GEN, PROMPT + 1),
                 ("yi-34b decode", 56, 8, 128, 2 * GEN, GEN + 1),
                 ("yi-34b L=520", 56, 8, 128, 520, 520),
                 ("gemma3 local ring", 32, 16, 128, 1024, 1024),
                 ("gemma3 global L=1288", 32, 16, 128, NLP_PROMPT + GEN, NLP_PROMPT + 1),
                 ("qwen2-moe decode", 16, 16, 128, 2 * GEN, GEN + 1),
                 ("jamba decode", 32, 8, 128, JAMBA_PROMPT + GEN, JAMBA_PROMPT + 1),
                 ("whisper self decode", 16, 16, 64, WHISPER_PROMPT + GEN, WHISPER_PROMPT + 1),
                 ("whisper cross decode", 16, 16, 64, 1500, 1500))


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
def cuda_ms(fn, sets, iters: int = 30) -> float:
    """Mean device time of fn(*inputs) in ms, cycling through input sets
    whose total exceeds the 50 MB L2, so each call reads device memory."""
    for args in sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies(tensors, min_bytes: int = 128 << 20):
    size = sum(t.numel() * t.element_size() for t in tensors)
    n = max(2, min(64, math.ceil(min_bytes / size)))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def flash_bound(b, sq, sk, h, kv, hd, dtype, window=None, causal=True):
    """Operations over the (query, key) pairs the mask keeps (causal: keys
    0..q, and past q - window; a row that keeps none weighs every key);
    bytes: Q and O over Sq, K and V over Sk."""
    def keys(q):
        if not causal:
            return sk
        n = min(q + 1, sk) - (max(0, q - window + 1) if window else 0)
        return n if n > 0 else sk
    pairs = sum(keys(q) for q in range(sq))
    flops = 4.0 * b * h * hd * pairs
    nbytes = (2 * b * sq * h * hd + 2 * b * sk * kv * hd) * torch.finfo(dtype).bits // 8
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def decode_bound(h, kv, hd, L, lengths, dtype):
    slots = sum(min(n, L) if n > 0 else L for n in lengths)
    b = len(lengths)
    flops = 4.0 * h * hd * slots
    nbytes = (2 * b * h * hd + 2 * kv * hd * slots) * torch.finfo(dtype).bits // 8 + 4 * b
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def ssd_bound(b, s, h, p, g, n, chunk, dtype):
    """Bytes: x, dt, a_neg, B and C read once, y and the f32 final state
    written once.  Operations: C.B^T once per (batch, chunk, group) and the
    per-head products, each over the lower triangle of a chunk's valid rows
    only."""
    item = torch.finfo(dtype).bits // 8
    nbytes = 2 * b * s * h * p * item + 4 * b * s * h + 4 * h + 2 * b * s * g * n * item \
        + 4 * b * h * p * n
    flops = 0.0
    for c0 in range(0, s, chunk):
        rows = min(chunk, s - c0)
        pairs = rows * (rows + 1) / 2
        flops += b * (2.0 * pairs * n * g + h * (2.0 * pairs * p + 4.0 * rows * p * n))
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def sdpa_prefill(q, k, v, window=None, causal=True):
    """The yardstick: causal, with an explicit causal window mask, or
    (``causal=False``) unmasked over Sk keys."""
    mask = None
    if window is not None:
        i = torch.arange(q.shape[1], device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        is_causal=causal and window is None,
        enable_gqa=q.shape[2] != k.shape[2]).transpose(1, 2)


def sdpa_backend(kernel_names):
    """Which of SDPA's backends ran, from its device kernels' names."""
    if not kernel_names:
        return "not known (no device kernel profiled)"
    for part, backend in (("cudnn", "cuDNN"), ("flash", "flash"), ("fmha", "efficient"),
                          ("efficient", "efficient")):
        if any(part in n.lower() for n in kernel_names):
            return backend
    return "math"


def sdpa_decode(q, k, v, lengths):
    mask = torch.arange(k.shape[1], device=q.device)[None, :] < lengths[:, None]
    return F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask[:, None, None, :], enable_gqa=q.shape[1] != k.shape[2])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} (torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(smi)
    return smi


def _kernel_label(mangled_line):
    """'flash_tc_kernel hd96' for a ptxas line naming flash_tc_kernel<96>,
    'ssd_out_kernel full' for ssd_out_kernel<true>, 'decode_split_kernel
    bf16/hd96/g1' for decode_split_kernel<bf16, 96, 1>."""
    m = re.search(r"(?<=\d)([a-z][a-z_]*_kernel)(?:I((?:f|13__nv_bfloat16|Li\d+E|Lb[01]E)+)E)?",
                  mangled_line)
    if not m:
        return None
    parts, ints = [], 0
    for tok in re.finditer(r"f|13__nv_bfloat16|Li(\d+)E|Lb[01]E", m.group(2) or ""):
        label = {"f": "f32", "13__nv_bfloat16": "bf16", "Lb1E": "full", "Lb0E": "any"}.get(
            tok.group(0))
        if label is None:   # integers: the head dim, then (K2) the heads a block
            label, ints = f"{('hd', 'g')[min(ints, 1)]}{tok.group(1)}", ints + 1
        parts.append(label)
    return m.group(1) + (" " + "/".join(parts) if parts else "")


def phase_build():
    """Build the three libraries at once; print each kernel's registers and
    spills (ptxas), each library's tensor-core instructions (cuobjdump
    -sass), and each kernel's dynamic shared memory and resident blocks per
    SM (the occupancy calculator, through the libraries' C interface)."""
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"build: {', '.join(reports)} with {_build.nvcc()} in "
        f"{time.perf_counter() - t0:.1f} s")
    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    hmma = {}
    for name, text in reports.items():
        found, current, spill = [], None, "0"
        for ln in text.splitlines():
            if "entry function" in ln or "Function properties for" in ln:
                current = _kernel_label(ln) or current
            spilled = re.search(r"(\d+) bytes spill stores", ln)
            if spilled:
                spill = spilled.group(1)
            used = re.search(r"Used (\d+) registers", ln)
            if used and current:
                found.append(f"{current}: {used.group(1)} regs, {spill} B spill stores")
                current, spill = None, "0"
        log(f"ptxas {name}: {'; '.join(found)}")
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build._lib_path(name))],
                              capture_output=True, text=True, timeout=120, check=True).stdout
        hmma[name] = (len(re.findall(r"\bHMMA\b", sass)), len(re.findall(r"\bHGMMA\b", sass)))
        log(f"sass {name}: {hmma[name][0]} HMMA, {hmma[name][1]} HGMMA instructions")
    assert hmma["flash_attention"][0] + hmma["flash_attention"][1] > 0, hmma
    assert hmma["ssd_scan"][0] + hmma["ssd_scan"][1] > 0, hmma

    # the kernels' shared memory is dynamic, so ptxas does not report it
    k1 = _build.load("flash_attention")
    for fn in (k1.repro_flash_attention_smem_bytes, k1.repro_flash_attention_blocks_per_sm):
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    occ = {}
    for hd in (32, 64, 96, 128):
        for bf, label in ((1, "bf16 tensor cores"), (0, "f32 CUDA cores")):
            occ[("flash_attention", hd, bf)] = k1.repro_flash_attention_blocks_per_sm(hd, bf)
            log(f"flash_attention hd{hd} {label}: "
                f"{k1.repro_flash_attention_smem_bytes(hd, bf)} B shared a block, "
                f"{occ[('flash_attention', hd, bf)]} blocks per SM")
    k2 = _build.load("decode_attention")
    for fn in (k2.repro_decode_attention_stages, k2.repro_decode_attention_smem_bytes,
               k2.repro_decode_attention_blocks_per_sm):
        fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    sms, waves = torch.cuda.get_device_properties(0).multi_processor_count, {}
    for label, h, kv, hd, L, _ in DECODE_SHAPES:
        splits, chunk = K2.split_plan(BATCH, kv, L)
        for bf in (1, 0):
            g = h // kv
            occ[("decode_attention", label, bf)] = k2.repro_decode_attention_blocks_per_sm(
                g, hd, bf, chunk)
            waves[(label, bf)] = BATCH * kv * splits / (occ[("decode_attention", label, bf)]
                                                       * sms)
            path = "tensor cores" if bf else "CUDA cores"
            log(f"decode_attention {label} (group {g}, hd{hd}) {('f32', 'bf16')[bf]} {path}: "
                f"{splits} splits of {chunk} slots, {BATCH * kv * splits} blocks, "
                f"{k2.repro_decode_attention_stages(g, hd, bf, chunk)} ring stages, "
                f"{k2.repro_decode_attention_smem_bytes(g, hd, bf, chunk)} B shared a block, "
                f"{occ[('decode_attention', label, bf)]} blocks per SM")
    k3 = _build.load("ssd_scan")
    k3.repro_ssd_scan_kernel_name.argtypes = [ctypes.c_int]
    k3.repro_ssd_scan_kernel_name.restype = ctypes.c_char_p
    for fn in (k3.repro_ssd_scan_smem_bytes, k3.repro_ssd_scan_blocks_per_sm):
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    for i in range(k3.repro_ssd_scan_kernel_count()):
        occ[("ssd_scan", i)] = k3.repro_ssd_scan_blocks_per_sm(i)
        log(f"ssd_scan {k3.repro_ssd_scan_kernel_name(i).decode()}: "
            f"{k3.repro_ssd_scan_smem_bytes(i)} B shared a block (every width), "
            f"{occ[('ssd_scan', i)]} blocks per SM")
    # the bf16 serving paths: two or more resident blocks an SM
    assert min(occ[("flash_attention", hd, 1)] for hd in (96, 128)) >= 2, occ
    assert min(occ[("ssd_scan", i)]
               for i in range(1, k3.repro_ssd_scan_kernel_count())) >= 2, occ
    # K2: every block of a decode step resident at once (one wave)
    assert max(waves.values()) <= 1, waves
    return hmma


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEV, dtype=torch.float32).to(dtype)


def _ssd_inputs(gen, b, s, h, p, g, n, dtype):
    """x, B, C standard normal; dt = softplus(normal); a_neg = -linspace(1,
    16, H), init_mamba's decay rates, so a 256-row chunk spans |cum| of a
    few thousand."""
    x = _randn(gen, (b, s, h, p), dtype)
    dt = F.softplus(_randn(gen, (b, s, h), torch.float32))
    a_neg = -torch.linspace(1.0, 16.0, h, device=DEV)
    return x, dt, a_neg, _randn(gen, (b, s, g, n), dtype), _randn(gen, (b, s, g, n), dtype)


def _ssd_check(label, got, want, dtype, rows, rounding=False):
    """One SSD parity case: y in its dtype's tolerance, the state in f32's;
    with ``rounding``, also the share of bf16 y that rounds to another value
    than the plain version's."""
    errs = []
    for g, w, dt in ((got[0], want[0], dtype), (got[1], want[1], torch.float32)):
        errs.append((g.float() - w.float()).abs().max().item())
        ok = torch.allclose(g.float(), w.float(), **SSD_TOL[dt])
        assert ok and torch.isfinite(g).all(), (label, errs)
    tol = SSD_TOL[dtype]
    share = ""
    if rounding:
        changed = (got[0] != want[0]).float().mean().item()
        assert changed <= SSD_ROUNDING_SHARE, (label, changed)
        share = f"; {changed:.3e} of y rounded otherwise (at most {SSD_ROUNDING_SHARE})"
    log(f"K3 {label} {str(dtype)[6:]}: max abs err y {errs[0]:.3e}, state {errs[1]:.3e} "
        f"(atol {tol['atol']}, rtol {tol['rtol']}){share} ok")
    rows.append({"case": f"{label} {str(dtype)[6:]}", "max_abs_err": max(errs),
                 "tol": tol})


def phase_parity_ssd(gen):
    """K3 against its plain version at mamba2-2.7b's widths: S 4 (what
    nlp-chain hands its third stage), 1000 (a ragged tail) and 1024; the
    reduced family's; G > 1; and a state carried across two halves."""
    bf, f32 = torch.bfloat16, torch.float32
    rows = []
    # (label, B, S, H, P, G, N, chunk, dtype)
    cases = [(f"mamba2-2.7b S={s}", BATCH, s, 80, 64, 1, 128, 256, dt)
             for s in (4, GEN, 1000, 1024) for dt in (bf, f32)]
    # jamba-v0.1-52b's mixer at full width: 128 heads of P 64, N 16
    cases += [(f"jamba N=16 S={s}", BATCH, s, 128, 64, 1, 16, 256, dt)
              for s in (JAMBA_PROMPT, 1000) for dt in (bf, f32)]
    cases += [("reduced P=32 N=16 chunk 32 S=100", BATCH, 100, 16, 32, 1, 16, 32, dt)
              for dt in (f32, bf)]
    cases += [("G=2 reduced S=300", 2, 300, 16, 32, 2, 16, 32, f32),
              ("G=2 full width S=600", 2, 600, 80, 64, 2, 128, 256, bf)]
    for label, b, s, h, p, g, n, chunk, dt in cases:
        args = _ssd_inputs(gen, b, s, h, p, g, n, dt)
        got = K3.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        _ssd_check(label, got, K3.ssd_scan_plain(*args, chunk), dt, rows,
                   rounding=dt == bf and h == 80)
    # the tensor-core passes' edges (bf16): S in {1, 15, 255, 257, 1000} at
    # every chunk size, cycling through every (P, N) the wrapper accepts and
    # G in {1, 2}
    pn = [(p, n) for p in K3.HEAD_DIMS for n in K3.STATE_DIMS]
    edge = []
    for chunk in K3.CHUNKS:
        for s in (1, 15, 255, 257, 1000):
            p, n = pn[len(edge) % len(pn)]
            edge.append((f"edge S={s} chunk {chunk} P={p} N={n} G={1 + len(edge) % 2}", 2, s,
                         4, p, 1 + len(edge) % 2, n, chunk, bf))
    for label, b, s, h, p, g, n, chunk, dt in edge:
        args = _ssd_inputs(gen, b, s, h, p, g, n, dt)
        got = K3.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        _ssd_check(label, got, K3.ssd_scan_plain(*args, chunk), dt, rows)
    for dt in (f32, bf):   # a state carried across two halves of S 1000
        x, dtv, a_neg, bm, cm = _ssd_inputs(gen, BATCH, 1000, 80, 64, 1, 128, dt)
        whole = K3.ssd_scan(x, dtv, a_neg, bm, cm, chunk=256)
        m = x.shape[1] // 2     # 500: neither half is a whole number of chunks
        halves = [[t[:, sl].contiguous() for t in (x, dtv)] + [a_neg]
                  + [t[:, sl].contiguous() for t in (bm, cm)]
                  for sl in (slice(0, m), slice(m, None))]
        y1, f1 = K3.ssd_scan(*halves[0], chunk=256)
        y2, f2 = K3.ssd_scan(*halves[1], chunk=256, init_state=f1)
        torch.cuda.synchronize()
        _ssd_check("mamba2-2.7b S=1000 in two halves vs one pass",
                   (torch.cat([y1, y2], 1), f2), whole, dt, rows)
        _ssd_check("mamba2-2.7b second half from a carried state vs plain", (y2, f2),
                   K3.ssd_scan_plain(*halves[1], 256, init_state=f1), dt, rows)
    return rows


def phase_parity():
    """Each kernel against its plain version; returns per-kernel parity rows."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    # (label, B, S, H, KV, hd, window, dtype)
    flash_cases = [(f"yi-34b S={s}", BATCH, s, 56, 8, 128, None, bf) for s in (16, 500, 512)]
    flash_cases += [(f"phi-3 S={s}", BATCH, s, 32, 32, 96, None, bf) for s in (16, 500, 512)]
    flash_cases += [("phi-3 S=500 window 64", BATCH, 500, 32, 32, 96, 64, bf)]
    # nlp-chain: gemma3's local layers (window 1024, group 2; at S 1100 the
    # window's edge falls inside a tile), its global layers, qwen2-moe's
    flash_cases += [(f"gemma3 local S={s} window 1024", BATCH, s, 32, 16, 128, 1024, dt)
                    for s in (NLP_PROMPT, 1100) for dt in (bf, f32)]
    flash_cases += [(f"gemma3 global S={NLP_PROMPT}", BATCH, NLP_PROMPT, 32, 16, 128, None, bf)]
    flash_cases += [(f"qwen2-moe S={s}", BATCH, s, 16, 16, 128, None, dt)
                    for s in (GEN, QWEN_PROMPT) for dt in (bf, f32)]
    # jamba's attention layer (group 4, hd 128)
    flash_cases += [(f"jamba S={JAMBA_PROMPT}", BATCH, JAMBA_PROMPT, 32, 8, 128, None, dt)
                    for dt in (bf, f32)]
    flash_cases += [(f"reduced hd={hd} S=16", BATCH, 16, h, kv, hd, None, f32)
                    for h, kv, hd in ((8, 2, 32), (4, 4, 64), (4, 4, 96))]
    flash_cases += [("reduced hd=64 S=130 window 64", 2, 130, 4, 2, 64, 64, f32)]
    # the tensor-core kernel's 64-row tiles (bf16): S around the tile edges,
    # hd 96 and 128, GQA groups 1 and 7, a window of 64 across tile edges
    flash_cases += [(f"edge S={s} hd={hd} group {h // kv}", 2, s, h, kv, hd, None, bf)
                    for s in (1, 8, 15, 17, 63, 65, 127, 129)
                    for h, kv, hd in ((4, 4, 96), (14, 2, 128))]
    flash_cases += [(f"edge S={s} hd={hd} group {h // kv} window 64", 2, s, h, kv, hd, 64, bf)
                    for s in (65, 129, 200) for h, kv, hd in ((4, 4, 96), (14, 2, 128))]
    # (label, B, Sq, Sk, H, KV, hd, window, causal, dtype): the cases above
    # are causal with Sq = Sk; whisper-medium's encoder (non-causal over 1500
    # frames: 23 tiles of 64 and a ragged 28) and its cross-attention prefill
    # (the 32-token prompt over the frames); causal with Sq < Sk and Sq > Sk
    # at ragged sizes; and windowed where from row 85 on (Sq 200 over Sk 70,
    # window 16) a row sees no key and the reference weighs every key alike
    flash_cases = [(label, b, s, s, h, kv, hd, w, True, dt)
                   for label, b, s, h, kv, hd, w, dt in flash_cases]
    flash_cases += [("whisper encoder S=1500 non-causal", BATCH, 1500, 1500, 16, 16, 64, None,
                     False, dt) for dt in (bf, f32)]
    flash_cases += [(f"whisper cross prefill Sq={WHISPER_PROMPT} Sk=1500", BATCH,
                     WHISPER_PROMPT, 1500, 16, 16, 64, None, False, dt) for dt in (bf, f32)]
    flash_cases += [(f"Sq={sq} Sk={sk} {'causal' if c else 'non-causal'}", 2, sq, sk, 4, 2, 64,
                     None, c, dt)
                    for sq, sk in ((37, 150), (150, 37)) for c in (True, False)
                    for dt in (bf, f32)]
    flash_cases += [("Sq=200 Sk=70 window 16 (rows from 85 see no key)", 2, 200, 70, 4, 2,
                     128, 16, True, dt) for dt in (bf, f32)]
    rows = {"flash_attention": [], "decode_attention": []}
    for label, b, sq, sk, h, kv, hd, window, causal, dt in flash_cases:
        q = _randn(gen, (b, sq, h, hd), dt)
        k, v = _randn(gen, (b, sk, kv, hd), dt), _randn(gen, (b, sk, kv, hd), dt)
        got = K1.flash_attention(q, k, v, window=window, causal=causal)
        torch.cuda.synchronize()
        want = K1.flash_attention_plain(q, k, v, window=window, causal=causal)
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), atol=TOL[dt], rtol=TOL[dt])
        log(f"K1 {label} {str(dt)[6:]}: max abs err {err:.3e} (tol {TOL[dt]}) "
            f"{'ok' if ok else 'FAIL'}")
        assert ok, label
        rows["flash_attention"].append({"case": f"{label} {str(dt)[6:]}",
                                        "max_abs_err": err, "tol": TOL[dt]})
    decode_cases = []
    for L in (20, 520):
        lengths = [0, L, 7, L // 2 + 3]
        for dt in (bf, f32):
            decode_cases += [(f"yi-34b L={L}", 56, 8, 128, L, lengths, dt),
                             (f"phi-3 L={L}", 32, 32, 96, L, lengths, dt)]
    decode_cases += [(f"reduced hd={hd} L=20", h, kv, hd, 20, [0, 20, 5, 17], f32)
                     for h, kv, hd in ((8, 2, 32), (4, 4, 64), (4, 4, 96))]
    # nlp-chain: gemma3's wrapped local ring (every slot valid), its global
    # cache over the decode steps, qwen2-moe's
    decode_cases += [(label, 32, 16, 128, L, lengths, dt)
                     for label, L, lengths in (
                         ("gemma3 local ring L=1024", 1024, [1024] * BATCH),
                         (f"gemma3 global L={NLP_PROMPT + GEN}", NLP_PROMPT + GEN,
                          [NLP_PROMPT + 1, NLP_PROMPT + GEN, NLP_PROMPT + 3, NLP_PROMPT + 5]))
                     for dt in (bf, f32)]
    decode_cases += [(f"qwen2-moe L={2 * GEN}", 16, 16, 128, 2 * GEN, [GEN + 1, 2 * GEN, 10, 13],
                      dt) for dt in (bf, f32)]
    decode_cases += [(f"jamba L={JAMBA_PROMPT + GEN}", 32, 8, 128, JAMBA_PROMPT + GEN,
                      [JAMBA_PROMPT + 1, JAMBA_PROMPT + GEN, 1, 130], dt) for dt in (bf, f32)]
    # whisper-medium's cross-attention decode: every request over all 1500
    # frames; its self-attention cache over the 8 decode steps
    decode_cases += [(label, 16, 16, 64, L, lengths, dt)
                     for label, L, lengths in (
                         ("whisper cross L=1500", 1500, [1500] * BATCH),
                         (f"whisper self L={WHISPER_PROMPT + GEN}", WHISPER_PROMPT + GEN,
                          [WHISPER_PROMPT + 1, WHISPER_PROMPT + GEN, 33, 36]))
                     for dt in (bf, f32)]
    # the split cache: at B 7 and L 200 the wrapper cuts 64-slot splits, so
    # these lengths are 0, 1, a split edge -1, +0, +1, L and beyond L
    decode_cases += [(f"split edges group {h // kv} hd={hd} L=200", h, kv, hd, 200,
                      [0, 1, 63, 64, 65, 200, 300], dt)
                     for h, kv, hd in ((2, 2, 32), (4, 4, 96), (14, 2, 128), (16, 2, 64),
                                       (8, 1, 32))
                     for dt in (bf, f32)]
    # L of 1, 64, 65 and 4096 (B 1: 4, 16 or 64 splits); groups 12 and 20 run
    # in two row chunks (of the CUDA-core and the tensor-core kernel)
    decode_cases += [(f"group {h // kv} hd={hd} L={L}", h, kv, hd, L, lengths, dt)
                     for L, h, kv, hd, lengths in (
                         (1, 4, 4, 64, [0, 1]), (1, 14, 2, 128, [1, 5]),
                         (64, 8, 1, 96, [63, 64, 0]), (65, 7, 1, 128, [64, 65, 1]),
                         (4096, 32, 32, 96, [4000]), (4096, 32, 32, 96, [257]),
                         (4096, 56, 8, 128, [4096]), (4096, 8, 1, 64, [0]),
                         (300, 24, 2, 128, [299, 65]), (100, 20, 1, 64, [50, 0]))
                     for dt in (bf, f32)]
    for label, h, kv, hd, L, lengths, dt in decode_cases:
        b = len(lengths)
        q = _randn(gen, (b, h, hd), dt)
        k, v = _randn(gen, (b, L, kv, hd), dt), _randn(gen, (b, L, kv, hd), dt)
        lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
        got = K2.decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        want = K2.decode_attention_plain(q, k, v, lens)
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), atol=TOL[dt], rtol=TOL[dt])
        log(f"K2 {label} lengths {lengths} {str(dt)[6:]}: max abs err {err:.3e} "
            f"(tol {TOL[dt]}) {'ok' if ok else 'FAIL'}")
        assert ok, label
        rows["decode_attention"].append({"case": f"{label} {str(dt)[6:]}",
                                         "max_abs_err": err, "tol": TOL[dt]})
    rows["decode_attention"].append(_k2_repeated_calls(gen))
    rows["ssd_scan"] = phase_parity_ssd(gen)
    return rows


def _k2_repeated_calls(gen):
    """K2's arrival counters reset: the phi-3 decode shape five times with
    new lengths, then the yi-34b and a reduced f32 shape in turn, each
    output against the plain version, every counter zero at the end."""
    shapes = [(32, 32, 96, PROMPT + GEN, torch.bfloat16), (56, 8, 128, 520, torch.bfloat16),
              (8, 2, 64, 300, torch.float32)]
    calls = [shapes[0]] * 5 + [shapes[1], shapes[2]] * 3 + [shapes[1], shapes[0]]
    err = 0.0
    for i, (h, kv, hd, L, dt) in enumerate(calls):
        q = _randn(gen, (BATCH, h, hd), dt)
        k, v = _randn(gen, (BATCH, L, kv, hd), dt), _randn(gen, (BATCH, L, kv, hd), dt)
        lens = torch.tensor([(37 * i + 61 * j) % (L + 20) for j in range(BATCH)],
                            dtype=torch.int32, device=DEV)
        got, want = K2.decode_attention(q, k, v, lens).float(), K2.decode_attention_plain(
            q, k, v, lens).float()
        e = (got - want).abs().max().item()
        assert torch.allclose(got, want, atol=TOL[dt], rtol=TOL[dt]), (i, e)
        err = max(err, e / TOL[dt])
    torch.cuda.synchronize()
    busy = sum(int(c.abs().sum()) for c in K2._counters.values())
    log(f"K2 repeated and alternating calls: {len(calls)} calls at 3 shapes, max abs err "
        f"{err:.3e} of the tolerance, arrival counters nonzero after: {busy}")
    assert busy == 0
    return {"case": "repeated and alternating calls", "max_abs_err_over_tol": err}


def phase_timing():
    """Kernel, plain version and SDPA at the serving path's shapes."""
    gen = torch.Generator(device=DEV).manual_seed(1)
    bf = torch.bfloat16
    out = {}
    # prefill: phi-3 stage (prompt 256), yi stage (prompt = phi-3's 8 tokens);
    # nlp-chain: gemma3's local and global layers (prompt 1280, and 1100 with
    # the window's edge inside a tile), qwen2-moe's stage (prompt = gemma3's
    # 8 tokens) and its kernel-vs-naive prompt; jamba's attention layer
    # whisper-medium: its encoder (non-causal over 1500 frames), its
    # decoder's self-attention prefill and its cross-attention prefill (the
    # prompt over the frames)
    for label, b, s, sk, h, kv, hd, window, causal in (
            ("phi-3 prefill", BATCH, PROMPT, PROMPT, 32, 32, 96, None, True),
            ("yi-34b prefill", BATCH, GEN, GEN, 56, 8, 128, None, True),
            ("yi-34b S=512", BATCH, 512, 512, 56, 8, 128, None, True),
            ("gemma3 local prefill", BATCH, NLP_PROMPT, NLP_PROMPT, 32, 16, 128, 1024, True),
            ("gemma3 local S=1100", BATCH, 1100, 1100, 32, 16, 128, 1024, True),
            ("gemma3 global prefill", BATCH, NLP_PROMPT, NLP_PROMPT, 32, 16, 128, None, True),
            ("qwen2-moe prefill", BATCH, GEN, GEN, 16, 16, 128, None, True),
            ("qwen2-moe S=256", BATCH, QWEN_PROMPT, QWEN_PROMPT, 16, 16, 128, None, True),
            ("jamba prefill", BATCH, JAMBA_PROMPT, JAMBA_PROMPT, 32, 8, 128, None, True),
            ("whisper encoder", BATCH, 1500, 1500, 16, 16, 64, None, False),
            ("whisper self prefill", BATCH, WHISPER_PROMPT, WHISPER_PROMPT, 16, 16, 64, None,
             True),
            ("whisper cross prefill", BATCH, WHISPER_PROMPT, 1500, 16, 16, 64, None, False)):
        q = _randn(gen, (b, s, h, hd), bf)
        k, v = _randn(gen, (b, sk, kv, hd), bf), _randn(gen, (b, sk, kv, hd), bf)
        sets = copies((q, k, v))
        kern = lambda q, k, v, w=window, c=causal: K1.flash_attention(  # noqa: E731
            q, k, v, window=w, causal=c)
        plain_fn = lambda q, k, v, w=window, c=causal: K1.flash_attention_plain(  # noqa: E731
            q, k, v, window=w, causal=c)
        sdpa = lambda q, k, v, w=window, c=causal: sdpa_prefill(q, k, v, w, c)  # noqa: E731
        got, want = kern(q, k, v).float(), plain_fn(q, k, v).float()
        err = (got - want).abs().max().item()
        assert torch.allclose(got, want, atol=TOL[bf], rtol=TOL[bf]), (label, err)
        lib_err = (sdpa(q, k, v).float() - want).abs().max().item()
        ms = cuda_ms(kern, sets)
        plain = cuda_ms(plain_fn, sets)
        lib = cuda_ms(sdpa, sets)
        bound, by = flash_bound(b, s, sk, h, kv, hd, bf, window, causal)
        ms32 = cuda_ms(kern, copies(tuple(t.float() for t in (q, k, v))))
        bound32, by32 = flash_bound(b, s, sk, h, kv, hd, torch.float32, window, causal)
        dev, _ = _log_device_kernels(f"K1 {label} bf16", kern, q, k, v)
        dev_lib, names = _log_device_kernels(f"SDPA {label} bf16", sdpa, q, k, v)
        log(f"time K1 {label} B={b} Sq={s} Sk={sk} H={h} KV={kv} hd={hd} window={window} "
            f"causal={causal} bf16: kernel "
            f"{ms:.4f} ms (device {dev:.4f}), plain {plain:.4f} ms, sdpa {lib:.4f} ms (device "
            f"{dev_lib:.4f}, {sdpa_backend(names)} backend, max abs err vs plain {lib_err:.3e}), "
            f"bound {bound:.4f} ms ({by}); f32 kernel {ms32:.4f} ms, bound {bound32:.4f} ms "
            f"({by32})")
        out[("flash_attention", label)] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                              bound_ms=bound, bound_by=by, max_abs_err=err,
                                              f32_ms=ms32, device_ms=dev,
                                              library_device_ms=dev_lib,
                                              library_backend=sdpa_backend(names))
    for label, h, kv, hd, L, n in DECODE_SHAPES:
        q = _randn(gen, (BATCH, h, hd), bf)
        k, v = _randn(gen, (BATCH, L, kv, hd), bf), _randn(gen, (BATCH, L, kv, hd), bf)
        lens = torch.full((BATCH,), n, dtype=torch.int32, device=DEV)
        sets = copies((q, k, v, lens))
        got = K2.decode_attention(q, k, v, lens).float()
        want = K2.decode_attention_plain(q, k, v, lens).float()
        err = (got - want).abs().max().item()
        assert torch.allclose(got, want, atol=TOL[bf], rtol=TOL[bf]), (label, err)
        ms = cuda_ms(K2.decode_attention, sets)
        plain = cuda_ms(K2.decode_attention_plain, sets)
        lib = cuda_ms(sdpa_decode, sets)
        bound, by = decode_bound(h, kv, hd, L, [n] * BATCH, bf)
        args32 = tuple(t.float() if t.is_floating_point() else t for t in (q, k, v, lens))
        ms32 = cuda_ms(K2.decode_attention, copies(args32))
        bound32, by32 = decode_bound(h, kv, hd, L, [n] * BATCH, torch.float32)
        log(f"time K2 {label} B={BATCH} L={L} lengths={n} H={h} KV={kv} hd={hd} bf16: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
            f"bound {bound:.4f} ms ({by}); f32 kernel {ms32:.4f} ms, bound {bound32:.4f} ms "
            f"({by32})")
        dev, _ = _log_device_kernels(f"K2 {label} bf16", K2.decode_attention, q, k, v, lens)
        dev32, _ = _log_device_kernels(f"K2 {label} f32", K2.decode_attention, *args32)
        dev_lib, names = _log_device_kernels(f"SDPA {label} bf16", sdpa_decode, q, k, v, lens)
        log(f"  SDPA {label}: {sdpa_backend(names)} backend")
        out[("decode_attention", label)] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                               bound_ms=bound, bound_by=by, max_abs_err=err,
                                               f32_ms=ms32, device_ms=dev, f32_device_ms=dev32,
                                               library_device_ms=dev_lib)
        _k2_split_sweep(label, q, k, v, lens)
    del q, k, v, lens, sets
    out[("decode_attention", K2_DRYRUN[0])] = _k2_dryrun_shape(gen)
    # SSD scan: the mamba2-2.7b prefill of the serve phase, the 8-token prompt
    # nlp-chain hands its third stage, and jamba's mixer (N 16)
    log("time K3: no single PyTorch call computes the SSD scan, so it has no "
        "library time (library_ms null)")
    for label, s, h, n in (("mamba2-2.7b prefill", MAMBA_PROMPT, 80, 128),
                           (f"mamba2-2.7b S={GEN}", GEN, 80, 128),
                           ("jamba prefill", JAMBA_PROMPT, 128, 16)):
        args = _ssd_inputs(gen, BATCH, s, h, 64, 1, n, bf)
        sets = copies(args)
        got, want = K3.ssd_scan(*args, chunk=256), K3.ssd_scan_plain(*args, 256)
        err = max((got[i].float() - want[i].float()).abs().max().item() for i in (0, 1))
        assert torch.allclose(got[0].float(), want[0].float(), **SSD_TOL[bf]), (label, err)
        ms = cuda_ms(lambda *a: K3.ssd_scan(*a, chunk=256), sets)
        plain = cuda_ms(lambda *a: K3.ssd_scan_plain(*a, 256), sets)
        bound, by = ssd_bound(BATCH, s, h, 64, 1, n, 256, bf)
        args32 = tuple(t.float() for t in args)
        ms32 = cuda_ms(lambda *a: K3.ssd_scan(*a, chunk=256), copies(args32))
        bound32, by32 = ssd_bound(BATCH, s, h, 64, 1, n, 256, torch.float32)
        dev, _ = _log_device_kernels(f"K3 {label} bf16", lambda *a: K3.ssd_scan(*a, chunk=256),
                                     *args)
        _log_device_kernels(f"K3 {label} f32", lambda *a: K3.ssd_scan(*a, chunk=256), *args32)
        log(f"time K3 {label} B={BATCH} S={s} H={h} P=64 G=1 N={n} chunk 256 bf16: kernel "
            f"{ms:.4f} ms (device {dev:.4f}), plain {plain:.4f} ms, bound {bound:.4f} ms ({by}); "
            f"f32 kernel {ms32:.4f} ms, bound {bound32:.4f} ms ({by32})")
        out[("ssd_scan", label)] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                       bound_ms=bound, bound_by=by, max_abs_err=err,
                                       f32_ms=ms32, device_ms=dev)
    return out


# K2 at the dry run's card probe (yi-34b x decode_32k): B 128, every one of
# 32768 slots valid: (label, B, H, KV, hd, L)
K2_DRYRUN = ("yi-34b decode_32k", 128, 56, 8, 128, 32768)
# the plain version repeats K and V over each GQA group in f32: 120 GB for
# the whole batch at once, so it runs on slices of this many requests
PLAIN_SLICE = 8
# Over 32768 valid slots with unit-normal q, k and v the outputs are about
# N(0, 0.009), at most ~0.05, so TOL's 2e-2 would pass a kernel that dropped
# a fifth of the cache.  rtol 2e-2 covers bf16's rounding of the output (one
# ulp is 2**-7 of it); atol 5e-4 is twice an ulp at the largest output.  A
# kernel that skips the last 64-slot tile (one split of the finest plan)
# is off by up to ~7e-3 and fails it; the phase checks that it does.
K2_DRYRUN_TOL = dict(atol=5e-4, rtol=2e-2)


def sdpa_decode_full(q, k, v, lengths):
    """SDPA over every slot (each request's length is the cache's): no
    mask, so a fused backend takes it, the math backend (which would repeat
    K and V over the groups) excluded."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        return F.scaled_dot_product_attention(q[:, :, None], k.transpose(1, 2),
                                              v.transpose(1, 2), enable_gqa=True)[:, :, 0]


def _k2_dryrun_shape(gen):
    """K2 against its plain version (on slices of the batch), timed beside
    its bound and SDPA, at the dry run's probe shape; one set of inputs
    (17 GB) is far past the 50 MB L2."""
    label, b, h, kv, hd, L = K2_DRYRUN
    bf = torch.bfloat16
    q = _randn(gen, (b, h, hd), bf)
    k, v = _randn(gen, (b, L, kv, hd), bf), _randn(gen, (b, L, kv, hd), bf)
    lens = torch.full((b,), L, dtype=torch.int32, device=DEV)
    sets = [(q, k, v, lens)]

    def plain(q, k, v, lens):
        return torch.cat([K2.decode_attention_plain(q[i:i + PLAIN_SLICE], k[i:i + PLAIN_SLICE],
                                                    v[i:i + PLAIN_SLICE],
                                                    lens[i:i + PLAIN_SLICE])
                          for i in range(0, b, PLAIN_SLICE)])
    got, want = K2.decode_attention(q, k, v, lens).float(), plain(q, k, v, lens).float()
    err = (got - want).abs().max().item()
    assert torch.allclose(got, want, **K2_DRYRUN_TOL), (label, err)
    # the tolerance tells the kernel from one that skips the last tile
    short = K2.decode_attention(q, k, v, lens - K2.SPLIT_SLOTS).float()
    short_err = (short - want).abs().max().item()
    assert not torch.allclose(short, want, **K2_DRYRUN_TOL), (label, short_err)
    lib_err = (sdpa_decode_full(q, k, v, lens).float() - want).abs().max().item()
    del got, short
    ms = cuda_ms(K2.decode_attention, sets, iters=20)
    plain_ms = cuda_ms(plain, sets, iters=3)
    lib = cuda_ms(sdpa_decode_full, sets, iters=20)
    bound, by = decode_bound(h, kv, hd, L, [L] * b, bf)
    dev, _ = _log_device_kernels(f"K2 {label} bf16", K2.decode_attention, q, k, v, lens)
    dev_lib, names = _log_device_kernels(f"SDPA {label} bf16", sdpa_decode_full, q, k, v, lens)
    log(f"time K2 {label} B={b} L={L} lengths={L} H={h} KV={kv} hd={hd} bf16: kernel "
        f"{ms:.4f} ms (device {dev:.4f}), plain {plain_ms:.4f} ms ({b // PLAIN_SLICE} slices "
        f"of {PLAIN_SLICE}), sdpa {lib:.4f} ms (device {dev_lib:.4f}, {sdpa_backend(names)} "
        f"backend, no mask, max abs err vs plain {lib_err:.3e}), bound {bound:.4f} ms ({by}); "
        f"max abs err {err:.3e} (atol {K2_DRYRUN_TOL['atol']}, rtol {K2_DRYRUN_TOL['rtol']}; "
        f"the last {K2.SPLIT_SLOTS} slots skipped: {short_err:.3e}, out of it); "
        f"f32 not timed at this shape (34 GB more)")
    _k2_split_sweep(label, q, k, v, lens, want=want, tol=K2_DRYRUN_TOL)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bound, bound_by=by,
                max_abs_err=err, device_ms=dev, library_device_ms=dev_lib,
                library_backend=sdpa_backend(names))


def _k2_split_sweep(label, q, k, v, lens, reps=20, want=None, tol=None):
    """K2's device time a launch with the cache cut into other numbers of
    splits than ``split_plan``'s, through the library's C entry (the
    wrapper takes no other): the evidence for the split rule.  Each output
    is held against the plain version (``want``, computed here by default)
    first, within ``tol`` (TOL of the dtype by default)."""
    lib, fn = K2._function()
    b, h, hd = q.shape
    L, kv = k.shape[1], k.shape[2]
    tiles = -(-L // K2.SPLIT_SLOTS)
    if want is None:
        want = K2.decode_attention_plain(q, k, v, lens).float()
    tol = tol or dict(atol=TOL[q.dtype], rtol=TOL[q.dtype])
    times = {}
    for ask in (1, 2, 3, 5, 9, tiles):
        per = -(-tiles // min(ask, tiles))
        splits = -(-tiles // per)
        if splits in times:
            continue
        ws = torch.empty(b * h * splits * (hd + 2), device=DEV)
        counters = torch.zeros(b * h, dtype=torch.int32, device=DEV)
        o = torch.empty_like(q)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), o.data_ptr(),
                ws.data_ptr(), counters.data_ptr(), b, L, h, kv, hd,
                int(q.dtype == torch.bfloat16), 1.0 / hd ** 0.5, splits, per * K2.SPLIT_SLOTS,
                torch.cuda.current_stream().cuda_stream)
        _build.check(lib, fn(*args), "decode_attention")
        torch.cuda.synchronize()
        assert torch.allclose(o.float(), want, **tol), splits
        _, kernels = _device_profile(f"K2 split sweep {label} {splits} splits",
                                     lambda _: [fn(*args) for _ in range(reps)],
                                     lambda ks: sum(e.count for e in ks) == reps)
        times[splits] = (sum(e.self_device_time_total for e in kernels) / 1e3 / reps
                         if kernels else None)
    log(f"K2 split sweep {label} {str(q.dtype)[6:]} (device ms a launch; split_plan "
        f"{K2.split_plan(b, kv, L)[0]}): "
        + ", ".join(f"{s} splits " + (f"{t:.4f}" if t is not None else "not measured")
                    for s, t in sorted(times.items())))


PROFILE_TRIES = 4


def _device_profile(label, run, complete=bool, tries=PROFILE_TRIES):
    """torch.profiler (CPU and CUDA activities) over ``run(attempt)`` and a
    synchronize; returns the profile and its device kernels' averages, or
    ``(None, [])`` where none of ``tries`` windows was ``complete`` (by
    default: recorded any device kernel).  On the card CUPTI now and then
    hands back a window with no device record, or with some records of a
    window missing; each such window is logged and taken again, and ``run``
    is told the attempt so that it may widen its window."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(attempt)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        if complete(kernels):
            return prof, kernels
        log(f"profiler: window {attempt + 1} of {tries} recorded "
            f"{sum(e.count for e in kernels)} device kernels, not a complete window ({label})")
        time.sleep(0.5)
    return None, []


def _log_device_kernels(label, fn, *args, reps=5):
    """The device kernels one call of fn launches, with their device time
    (torch.profiler over ``reps`` calls, four times as many at each retry,
    per call); returns their sum in ms and their names.  A window is
    complete when it recorded a device kernel and a whole number of them a
    call.  Where no window is, the time is the CUDA-event time a call over
    back-to-back calls instead (launch gaps included), the names are empty,
    and the log says so.
    The launch counters count calls, not these."""
    fn(*args)
    torch.cuda.synchronize()
    calls = []

    def run(attempt):
        calls.append(reps * 4 ** attempt)
        for _ in range(calls[-1]):
            fn(*args)
    def whole(kernels):
        n = sum(e.count for e in kernels)
        return n > 0 and n % calls[-1] == 0
    _, kernels = _device_profile(label, run, whole)
    if not kernels:
        ms = cuda_ms(fn, [args], iters=4 * reps)
        log(f"device kernels per call, {label}: the profiler recorded no complete window in "
            f"{PROFILE_TRIES}; CUDA-event time a call instead {ms:.4f} ms")
        return ms, []
    n = calls[-1]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    each = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3 / n:.4f} ms"
                     for e in kernels)
    log(f"device kernels per call, {label}: {sum(e.count for e in kernels) / n:g}, "
        f"{total:.4f} ms ({each})")
    return total, [e.key for e in kernels]


def _full_width_stages():
    phi = configs.get_config("phi-3-vision-4.2b")
    yi_full = configs.get_config("yi-34b")
    yi = dataclasses.replace(yi_full, n_layers=YI_LAYERS)
    gib = lambda c: c.n_params() * 2 / 2**30  # noqa: E731  (bf16 weights)
    log(f"phi-3-vision-4.2b: published config, {phi.n_layers} layers, d {phi.d_model}, "
        f"{phi.n_params() / 1e9:.2f} B params, {gib(phi):.2f} GiB of bf16 weights")
    log(f"yi-34b: full width (d {yi.d_model}, {yi.n_heads} heads, {yi.n_kv_heads} KV heads, "
        f"d_ff {yi.d_ff}), depth cut from {yi_full.n_layers} to {yi.n_layers} layers: "
        f"{yi.n_params() / 1e9:.2f} B params, {gib(yi):.2f} GiB "
        f"(all {yi_full.n_layers} layers: {gib(yi_full):.2f} GiB)")
    # each stage's accuracy label is its family's most accurate variant's
    acc = {a: max(x for _, _, x in configs.get_variant_family(a))
           for a in ("phi-3-vision-4.2b", "yi-34b")}
    return [StageServer("phi-3-vision-4.2b", [("phi-3-vision-4.2b", phi, acc["phi-3-vision-4.2b"])],
                        gen_tokens=GEN, max_ctx=2 * PROMPT, seed=0),
            StageServer("yi-34b", [("yi-34b-12L", yi, acc["yi-34b"])],
                        gen_tokens=GEN, max_ctx=2 * PROMPT, seed=1)]


def phase_serve():
    t0 = time.perf_counter()
    servers = _full_width_stages()
    torch.cuda.synchronize()
    log(f"init: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    engine = PipelineEngine(servers)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 32_064, (BATCH, PROMPT)).astype(np.int32) for _ in range(3)]
    engine.serve(prompts[0])                      # first use: cuBLAS handles, kernel loads
    torch.cuda.reset_peak_memory_stats()
    lats = []
    for p in prompts[1:]:
        out, lat = engine.serve(p)
        lats.append(lat)
        assert out.shape == (BATCH, GEN) and out.dtype == np.int32
        assert ((out >= 0) & (out < servers[1].config.vocab)).all()
        log(f"served batch B={BATCH} S={PROMPT}: tokens {out.tolist()}, stage latencies "
            f"{[f'{x * 1e3:.3f} ms' for x in lat]}, PAS {engine.pas:.4f}")
    n_batches = len(prompts) - 1
    n_attn = sum(s.config.n_layers for s in servers)
    want = {"flash_attention": n_attn * n_batches, "decode_attention": n_attn * GEN * n_batches,
            "ssd_scan": 0}
    peak = torch.cuda.max_memory_allocated()
    launches = served_launches("vlm-classify launches",
                               lambda: [engine.serve(p) for p in prompts[1:]], want)
    log(f"launches over {n_batches} batches, on the device: {launches} (expected {want}); "
        f"peak memory {peak / 2**30:.2f} GiB")
    assert launches == want, launches
    return servers, launches, lats


def reset_launches():
    K1.flash_attention.launches = 0
    K2.decode_attention.launches = 0
    K3.ssd_scan.launches = 0


def read_launches():
    return {"flash_attention": K1.flash_attention.launches,
            "decode_attention": K2.decode_attention.launches,
            "ssd_scan": K3.ssd_scan.launches}


# each kernel wrapper's device kernels, by a piece of their names: K1 and
# K2 run one kernel a call, K3 a chain that ends in its output kernel
# (``ssd_kernel`` alone in f32)
PORT_KERNELS = {"flash_attention": ("::flash_kernel", "::flash_tc_kernel"),
                "decode_attention": ("::decode_split_",),
                "ssd_scan": ("::ssd_kernel", "::ssd_out_kernel")}


def served_launches(label, serve, want):
    """Each wrapper's kernels that ran on the device in ``serve()``, counted
    by name in a torch.profiler trace: the wrappers' counters count their
    calls, and a stage's decode steps replay a CUDA graph, which calls
    none.  CUPTI now and then loses records of a window (``_device_profile``),
    so a window whose counts are not ``want`` is logged and taken again;
    returns the last window's counts."""
    seen = []

    def complete(kernels):
        seen.append({name: sum(e.count for e in kernels if any(p in e.key for p in pats))
                     for name, pats in PORT_KERNELS.items()})
        if seen[-1] != want:
            log(f"{label}: a window counted launches {seen[-1]}, not {want}")
        return seen[-1] == want

    _device_profile(label, lambda _: serve(), complete)
    return seen[-1]


class _RouteReplay:
    """Records the experts each top-k of ``repro_torch.models.moe`` picks in
    one run and checks a second run's picks against them, in the same
    order.  With ``replay`` the second run routes every token to the
    recorded experts, its weights its own probabilities at them: two paths
    compared under one routing differ by their rounding only, not by the
    routings a near tie flips.  Without, ``moved`` counts the tokens that
    the second run routed otherwise."""

    def __init__(self, replay):
        self.picks, self.replay, self.second, self.moved = [], replay, False, 0
        self._fn = MO._top_k

    def __enter__(self):
        def top_k(probs, k):
            if not self.second:
                vals, idx = self._fn(probs, k)
                self.picks.append(idx)
                return vals, idx
            # one routing group: the einsum dispatch routes (1, T, E), the
            # gather dispatch (T, E)
            first = self.picks.pop(0).reshape(*probs.shape[:-1], k)
            if self.replay:
                return probs.gather(-1, first), first
            vals, idx = self._fn(probs, k)
            self.moved += int((idx != first).any(-1).sum())
            return vals, idx
        MO._top_k = top_k
        return self

    def __exit__(self, *exc):
        MO._top_k = self._fn


def _kernel_and_naive_logits(cfg, params, prompt=PROMPT, impls=("kernel", "naive"),
                             moe_impls=("einsum", "einsum"), replay=False):
    """Prefill + 2 decode steps with the kernels and with the naive paths
    (attention, SSD scan), on the same weights and prompt: logits (3, B, V)
    for each of ``impls`` (each with its MoE dispatch from ``moe_impls``).
    With ``replay`` the second run routes every token to the experts the
    first picked; without, it must route every token as the first did
    (``_RouteReplay``)."""
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (BATCH, prompt)).astype(np.int64)).to(DEV)
    runs = []
    routes = _RouteReplay(replay)
    with torch.inference_mode(), routes:
        for i, (impl, moe_impl) in enumerate(zip(impls, moe_impls)):
            routes.second = i > 0
            hl, caches, s = M.prefill(params, cfg, {"tokens": toks}, impl=impl,
                                      moe_impl=moe_impl, capacity=prompt + 2)
            lgs = [hl @ params["embed"].T]
            for step in range(2):
                tok = toks[:, step:step + 1]
                lg, caches = M.decode_step(params, cfg, caches, s + step, tok, impl=impl,
                                           moe_impl=moe_impl)
                lgs.append(lg)
            runs.append(torch.stack(lgs).float())
    if len(runs) > 1:
        assert not routes.picks, "the runs routed a different number of times"
        assert routes.moved == 0, f"{routes.moved} tokens routed otherwise by the second run"
    return tuple(runs)


def phase_kernel_vs_naive(server):
    """One full-width stage through the kernels and through the naive path.

    In f32 (fresh weights from a seed) the logits must agree within 2e-4.
    In bf16 (the served weights) 32 layers of bf16 rounding carry the
    kernels' one-ulp differences in attention output into the logits, so
    the difference is printed beside the tolerance and the greedy tokens
    must agree wherever the top-2 margin exceeds it."""
    cfg32 = dataclasses.replace(server.config, dtype=torch.float32)
    params32 = M.init(cfg32, seed=2)
    kern, naive = _kernel_and_naive_logits(cfg32, params32)
    del params32
    diff32 = (kern - naive).abs().max().item()
    ok32 = torch.allclose(kern, naive, atol=TOL[torch.float32], rtol=TOL[torch.float32])
    log(f"kernel vs naive ({server.name} full width, f32, prefill + 2 decode steps): max "
        f"logit diff {diff32:.4e} (tol {TOL[torch.float32]}) {'ok' if ok32 else 'FAIL'}")
    assert ok32 and torch.isfinite(kern).all()

    kern, naive = _kernel_and_naive_logits(server.config, server.params[server.active])
    _bf16_greedy_agreement(f"{server.name} full width", kern, naive)


def _bf16_greedy_agreement(label, kern, naive, what="kernel vs naive"):
    """bf16 logits of the kernel and naive paths: the difference is printed
    beside the tolerance, and the greedy tokens must agree wherever the
    naive path's top-2 margin exceeds it, which must hold somewhere."""
    tol = TOL[torch.bfloat16]
    diff = (kern - naive).abs().max().item()
    close = torch.isclose(kern, naive, atol=tol, rtol=tol).float().mean().item()
    top2 = naive.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > tol
    same = kern.argmax(-1) == naive.argmax(-1)
    log(f"{what} ({label}, bf16, prefill + 2 decode steps): max logit diff "
        f"{diff:.4e}, {close:.6f} of logits within atol=rtol={tol}; greedy tokens agree on "
        f"{int(same[clear].sum())}/{int(clear.sum())} positions whose top-2 margin exceeds "
        f"{tol} (of {clear.numel()})")
    assert torch.isfinite(kern).all()
    assert bool(clear.any()) and bool(same[clear].all())


def _f32_agreement(label, kern, naive, tol=None):
    """f32 logits of two paths within ``tol`` (atol and rtol; 2e-4 by
    default) at every position."""
    tol = tol or dict(atol=TOL[torch.float32], rtol=TOL[torch.float32])
    diff = (kern - naive).abs().max().item()
    ok = torch.allclose(kern, naive, **tol)
    log(f"{label} (f32, prefill + 2 decode steps): max logit diff {diff:.4e} ({tol}) "
        f"{'ok' if ok else 'FAIL'}")
    assert ok and torch.isfinite(kern).all()


def phase_trace(serve_batch, wall_s):
    """Where a served batch's device time goes: torch.profiler over one call
    of ``serve_batch``, device time by kernel, and the device's busy share
    of the unprofiled wall time."""
    _, kernels = _device_profile("trace", lambda _: serve_batch())
    if not kernels:
        log(f"trace: the profiler recorded no device kernel in {PROFILE_TRIES} windows; "
            f"device busy time not measured (unprofiled wall {wall_s * 1e3:.3f} ms)")
        return None
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"trace: device busy {busy_ms:.3f} ms in one served batch; unprofiled wall "
        f"{wall_s * 1e3:.3f} ms; busy share {busy_ms / (wall_s * 1e3):.4f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")
    for port in ("flash_kernel", "flash_tc_kernel", "decode_split", "ssd_"):
        mine = [e for e in kernels if f"::{port}" in e.key]
        if mine:
            ms = sum(e.self_device_time_total for e in mine) / 1e3
            log(f"  port kernels {port}*: {ms:.3f} ms in {sum(e.count for e in mine)} launches, "
                f"{ms / busy_ms:.4f} of the busy time")
    return busy_ms


def phase_profile(phi_server):
    t0 = time.perf_counter()
    pipe, engine = build_pipeline("vlm-classify", profile_batches=(1, 2, 4), verbose=False)
    for st in pipe.stages:
        log(f"profiled stage {st.name} (reduced f32 family): SLA {st.sla:.6f} s")
        for v in st.variants:
            log(f"  {v.name}: latency(1) {float(v.latency(1)) * 1e3:.4f} ms, "
                f"base_alloc {v.base_alloc}")
    out, lat = engine.serve(np.zeros((2, 16), np.int32))
    assert out.shape == (2, 4)
    profs = PF.profile_stage_server(phi_server, batches=(1, 2, 4))
    stage = PF.build_stage(phi_server.name, profs, th=2.0, batch_choices=(1, 2, 4),
                           max_batch=4)
    for p in profs:
        log(f"profiled full-width {p.name}: batches {p.batches} latencies "
            f"{[f'{x * 1e3:.3f} ms' for x in p.latencies]}")
    for v in stage.variants:
        log(f"  {v.name}: latency(1) {float(v.latency(1)) * 1e3:.4f} ms, "
            f"base_alloc {v.base_alloc}; stage SLA {stage.sla:.6f} s")
    log(f"profile phase: {time.perf_counter() - t0:.1f} s; pipeline SLA_P {pipe.sla:.6f} s")
    return pipe


REPLICA_NOTE = "(latencies measured at R = 1 on one card; R > 1 modelled as l / R^0.75)"


def _pick(sol):
    if not sol.feasible:
        return "infeasible"
    cfg = ", ".join(f"{st.variant} b{st.batch} x{st.replicas}" for st in sol.config.stages)
    return f"[{cfg}] PAS {sol.pas:.4f} cost {sol.cost:.0f} latency {sol.latency:.6f} s"


def phase_planner(pipe):
    """IPA's decision on latencies profiled on the card: the port's
    ``solve_vec`` and ``solve_brute`` must pick the same config, objective,
    PAS, cost and latency for the vlm-classify PipelineModel at each rate."""
    t0 = time.perf_counter()
    obj = OPT.Objective(**PLANNER_OBJ)
    log(f"planner on the card-profiled vlm-classify (SLA_P {pipe.sla:.6f} s, objective "
        f"{PLANNER_OBJ}) {REPLICA_NOTE}")
    for lam in PLANNER_RPS:
        vec = OPT.solve_vec(pipe, lam, obj)
        brute = OPT.solve_brute(pipe, lam, obj)
        agree = (vec.feasible == brute.feasible and vec.config == brute.config
                 and (vec.objective, vec.pas, vec.cost, vec.latency)
                 == (brute.objective, brute.pas, brute.cost, brute.latency))
        log(f"  {lam:g} rps: solve_vec {_pick(vec)} against SLA_P {pipe.sla:.6f} s; "
            f"objective {vec.objective:.6f}; solve_brute agrees: {agree} {REPLICA_NOTE}")
        log(f"  {lam:g} rps: fa2_low {_pick(BL.fa2(pipe, lam, 'low'))}; "
            f"rim {_pick(BL.rim(pipe, lam))} {REPLICA_NOTE}")
        assert agree, (lam, vec, brute)
        assert vec.feasible and vec.latency <= pipe.sla, (lam, vec)
    log(f"planner phase: {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# the Mamba2 path
# ---------------------------------------------------------------------------
def phase_serve_mamba():
    """mamba2-2.7b at its published config as a one-stage pipeline: batch 4,
    1024-token prompts, 8 generated tokens; every prefill runs K3 once per
    layer and decode runs no kernel of the port."""
    cfg = configs.get_config("mamba2-2.7b")
    s = cfg.ssm
    log(f"mamba2-2.7b: published config, {cfg.n_layers} layers, d {cfg.d_model}, "
        f"d_state {s.d_state}, head_dim {s.head_dim} ({s.n_heads(cfg.d_model)} heads), "
        f"expand {s.expand}, groups {s.n_groups}, chunk {s.chunk_size}, vocab {cfg.vocab}; "
        f"{cfg.n_params() / 1e9:.2f} B params, {cfg.n_params() * 2 / 2**30:.2f} GiB of bf16 "
        "weights")
    acc = max(x for _, _, x in configs.get_variant_family("mamba2-2.7b"))
    t0 = time.perf_counter()
    server = StageServer("mamba2-2.7b", [("mamba2-2.7b", cfg, acc)], gen_tokens=GEN,
                         max_ctx=MAMBA_PROMPT + GEN, seed=3)
    torch.cuda.synchronize()
    log(f"init: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    engine = PipelineEngine([server])
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, (BATCH, MAMBA_PROMPT)).astype(np.int32)
               for _ in range(3)]
    engine.serve(prompts[0])
    torch.cuda.reset_peak_memory_stats()
    lats = []
    for p in prompts[1:]:
        out, lat = engine.serve(p)
        lats.append(lat)
        assert out.shape == (BATCH, GEN) and out.dtype == np.int32
        assert ((out >= 0) & (out < cfg.vocab)).all()
        log(f"served batch B={BATCH} S={MAMBA_PROMPT}: tokens {out.tolist()}, stage latency "
            f"{lat[0] * 1e3:.3f} ms, PAS {engine.pas:.4f}")
    n_batches = len(prompts) - 1
    want = {"flash_attention": 0, "decode_attention": 0, "ssd_scan": cfg.n_layers * n_batches}
    peak = torch.cuda.max_memory_allocated()
    launches = served_launches("mamba2 launches", lambda: [engine.serve(p) for p in prompts[1:]],
                               want)
    log(f"launches over {n_batches} batches, on the device: {launches} (expected {want}); "
        f"peak memory {peak / 2**30:.2f} GiB")
    assert launches == want, launches
    return server, launches, lats


def _ssd_exact(x, dt, a_neg, b_mat, c_mat, *, chunk=256, init_state=None):
    """The chunked SSD scan in float64 (the algebra of ``ssd_scan_plain``,
    direct segment sums included), y rounded to x's dtype once: an exact
    evaluation of the function that K3 and its plain version compute in
    f32.  The yardstick of the bf16 mamba2 model check."""
    b, s, h, p = x.shape
    n, hpg = b_mat.shape[3], h // b_mat.shape[2]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    f = lambda t: F.pad(t.double(), (0, 0) * (t.dim() - 2) + (0, pad))  # noqa: E731
    xc = (f(x) * f(dt)[..., None]).reshape(b, nc, chunk, h, p)
    bc = f(b_mat).repeat_interleave(hpg, dim=2).reshape(b, nc, chunk, h, n)
    cc = f(c_mat).repeat_interleave(hpg, dim=2).reshape(b, nc, chunk, h, n)
    da = (f(dt) * a_neg.double()).reshape(b, nc, chunk, h).movedim(-1, 2)   # (b,nc,h,l)
    lmat = torch.exp(K3.segsum(da))
    y = torch.einsum("bchls,bcshp->bclhp", torch.einsum("bclhn,bcshn->bchls", cc, bc) * lmat, xc)
    states = torch.einsum("bcshn,bcshp->bchpn", bc, xc * lmat[..., -1, :].movedim(2, 3)[..., None])
    state = (torch.zeros((b, h, p, n), dtype=torch.float64, device=x.device)
             if init_state is None else init_state.double())
    for c in range(nc):
        y[:, c] += torch.einsum("blhn,bhpn->blhp", cc[:, c], state) \
            * torch.exp(torch.cumsum(da[:, c], -1)).movedim(1, 2)[..., None]
        state = state * torch.exp(da[:, c].sum(-1))[..., None, None] + states[:, c]
    return y.reshape(b, nc * chunk, h, p)[:, :s].to(x.dtype), state.float()


def _greedy_changes(logits, ref, margin):
    """How many of ``ref``'s positions whose top-2 margin exceeds ``margin``
    get another greedy token from ``logits``, and how many there are."""
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > margin
    return int(((logits.argmax(-1) != ref.argmax(-1)) & clear).sum()), int(clear.sum())


def phase_mamba_kernel_vs_naive(server):
    """The full-width stage through K3 and through the naive SSD path, with
    a prompt of whole chunks (1024) and one with a ragged tail (1000).  In
    f32 (fresh weights from a seed) the logits agree within the reference's
    Mamba tolerance.

    In bf16 (the served weights) 64 layers of bf16 rounding turn any change
    in the f32 rounding of the scan into logit differences near 0.2, so the
    naive path is no exact yardstick: against an exact (float64) evaluation
    of the same scan, ``_ssd_exact``, it moves the logits by about 0.2 and
    changes greedy tokens whose top-2 margin is 0.06.  Both paths are held
    against that exact evaluation, and the kernel path must come no farther
    from it than the naive path does: in max logit difference, and in the
    greedy tokens it changes where the exact path's top-2 margin exceeds
    2e-2.  A K3 that takes an f32 operand as two bf16 terms, or as one,
    fails this."""
    cfg32 = dataclasses.replace(server.config, dtype=torch.float32)
    params32 = M.init(cfg32, seed=4)
    for prompt in (MAMBA_PROMPT, 1000):
        kern, naive = _kernel_and_naive_logits(cfg32, params32, prompt)
        diff = (kern - naive).abs().max().item()
        ok = torch.allclose(kern, naive, **MAMBA_TOL)
        log(f"kernel vs naive (mamba2-2.7b full width, f32, S={prompt}, prefill + 2 decode "
            f"steps): max logit diff {diff:.4e}, max |logit| {naive.abs().max().item():.3e} "
            f"(atol {MAMBA_TOL['atol']}, rtol {MAMBA_TOL['rtol']}) {'ok' if ok else 'FAIL'}")
        assert ok and torch.isfinite(kern).all()
    del params32
    torch.cuda.empty_cache()
    params, tol = server.params[server.active], TOL[torch.bfloat16]
    for prompt in (MAMBA_PROMPT, 1000):
        kern, naive = _kernel_and_naive_logits(server.config, params, prompt)
        kernel_scan = ops.ssd_scan
        ops.ssd_scan = _ssd_exact     # the kernel path's SSD, evaluated exactly
        try:
            (exact,) = _kernel_and_naive_logits(server.config, params, prompt, ("kernel",))
        finally:
            ops.ssd_scan = kernel_scan
        diff = {k: (t - exact).abs().max().item() for k, t in (("kernel", kern), ("naive", naive))}
        (changed, clear), (changed_naive, _) = (_greedy_changes(t, exact, tol)
                                                for t in (kern, naive))
        log(f"kernel and naive vs exact SSD (mamba2-2.7b full width, S={prompt}, bf16, "
            f"prefill + 2 decode steps): max logit diff {diff['kernel']:.4e} (naive "
            f"{diff['naive']:.4e}); greedy tokens changed at {changed} (naive {changed_naive}) "
            f"of {clear} positions whose top-2 margin exceeds {tol} (of {exact[..., 0].numel()}); "
            f"kernel vs naive max logit diff {(kern - naive).abs().max().item():.4e}")
        assert torch.isfinite(kern).all()
        assert diff["kernel"] <= diff["naive"] and changed <= changed_naive, \
            (prompt, diff, changed, changed_naive)


def phase_profile_mamba(server):
    """The reduced mamba2 family as ``build_pipeline`` profiles a stage, and
    the full-width stage."""
    t0 = time.perf_counter()
    fam = configs.get_variant_family("mamba2-2.7b")
    reduced = StageServer("mamba2-2.7b", fam, gen_tokens=4)
    for srv, label in ((reduced, "reduced f32 family"), (server, "full width")):
        profs = PF.profile_stage_server(srv, batches=(1, 2, 4))
        stage = PF.build_stage(srv.name, profs, th=2.0, batch_choices=(1, 2, 4),
                               max_batch=4)
        for p in profs:
            log(f"profiled {label} {p.name}: batches {p.batches} latencies "
                f"{[f'{x * 1e3:.3f} ms' for x in p.latencies]}")
        for v in stage.variants:
            log(f"  {v.name}: latency(1) {float(v.latency(1)) * 1e3:.4f} ms, "
                f"base_alloc {v.base_alloc}")
        log(f"  stage SLA {stage.sla:.6f} s")
    log(f"mamba2 profile phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# nlp-chain: gemma3 -> qwen2-moe -> mamba2, and jamba
# ---------------------------------------------------------------------------
def _gib(cfg):
    return cfg.n_params() * 2 / 2**30      # bf16 weights


def _best_accuracy(arch):
    return max(x for _, _, x in configs.get_variant_family(arch))


def _nlp_chain_stages():
    gemma_full = configs.get_config("gemma3-27b")
    gemma = dataclasses.replace(gemma_full, n_layers=GEMMA_LAYERS)
    qwen, mamba = configs.get_config("qwen2-moe-a2.7b"), configs.get_config("mamba2-2.7b")
    m = qwen.moe
    log(f"gemma3-27b: full width (d {gemma.d_model}, {gemma.n_heads} heads, {gemma.n_kv_heads} "
        f"KV heads, hd {gemma.head_dim_}, d_ff {gemma.d_ff}, vocab {gemma.vocab}, window "
        f"{gemma.sliding_window}, global layers "
        f"{[i for i in range(gemma.n_layers) if gemma.is_global_layer(i)]}), depth cut from "
        f"{gemma_full.n_layers} to {gemma.n_layers} layers: {_gib(gemma):.2f} GiB (all "
        f"{gemma_full.n_layers}: {_gib(gemma_full):.2f} GiB)")
    log(f"qwen2-moe-a2.7b: published config, {qwen.n_layers} layers, d {qwen.d_model}, "
        f"{m.n_experts} experts top-{m.top_k} of d_ff {m.d_ff_expert}, {m.n_shared_experts} "
        f"shared (d_ff {m.d_ff_shared}), capacity factor {m.capacity_factor}; {_gib(qwen):.2f} GiB")
    log(f"mamba2-2.7b: published config, {_gib(mamba):.2f} GiB; the chain "
        f"{_gib(gemma) + _gib(qwen) + _gib(mamba):.2f} GiB")
    return [StageServer("gemma3-27b", [("gemma3-27b-24L", gemma, _best_accuracy("gemma3-27b"))],
                        gen_tokens=GEN, max_ctx=NLP_PROMPT + GEN, seed=5),
            StageServer("qwen2-moe-a2.7b", [("qwen2-moe-a2.7b", qwen,
                                             _best_accuracy("qwen2-moe-a2.7b"))],
                        gen_tokens=GEN, seed=6),
            StageServer("mamba2-2.7b", [("mamba2-2.7b", mamba, _best_accuracy("mamba2-2.7b"))],
                        gen_tokens=GEN, seed=7)]


def phase_serve_nlp():
    """nlp-chain at full width: B 4, a 1280-token prompt to gemma3, 8 tokens
    handed on by each stage.  Per batch: K1 once per attention layer's
    prefill (gemma3 and qwen2-moe), K2 once per attention layer and decode
    step, K3 once per mamba2 layer's prefill."""
    t0 = time.perf_counter()
    servers = _nlp_chain_stages()
    torch.cuda.synchronize()
    log(f"init: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    engine = PipelineEngine(servers)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, servers[0].config.vocab, (BATCH, NLP_PROMPT)).astype(np.int32)
               for _ in range(3)]
    engine.serve(prompts[0])
    torch.cuda.reset_peak_memory_stats()
    lats = []
    for p in prompts[1:]:
        out, lat = engine.serve(p)
        lats.append(lat)
        assert out.shape == (BATCH, GEN) and out.dtype == np.int32
        assert ((out >= 0) & (out < servers[2].config.vocab)).all()
        log(f"served nlp-chain batch B={BATCH} S={NLP_PROMPT}: tokens {out.tolist()}, stage "
            f"latencies {[f'{x * 1e3:.3f} ms' for x in lat]}, PAS {engine.pas:.4f}")
    n = len(prompts) - 1
    n_attn = servers[0].config.n_layers + servers[1].config.n_layers
    want = {"flash_attention": n_attn * n, "decode_attention": n_attn * GEN * n,
            "ssd_scan": servers[2].config.n_layers * n}
    peak = torch.cuda.max_memory_allocated()
    launches = served_launches("nlp-chain launches", lambda: [engine.serve(p) for p in prompts[1:]],
                               want)
    log(f"nlp-chain launches over {n} batches, on the device: {launches} (expected {want}); "
        f"peak memory {peak / 2**30:.2f} GiB")
    assert launches == want, launches
    return servers, launches, lats


def phase_moe_time(server):
    """Device time of the qwen2-moe stage's MoE layers over one served
    batch, by kernel name: routing, dispatch and combine (the einsums),
    the expert products, the shared experts.  torch.profiler ranges are
    put around ``moe_apply``, ``_expert_ffn`` and ``layers.mlp`` for this
    run only, and each device kernel is charged to the innermost."""
    from torch.profiler import record_function
    saved = MO.moe_apply, MO._expert_ffn, ML.mlp

    def ranged(name, fn):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run
    MO.moe_apply, MO._expert_ffn, ML.mlp = (ranged("moe.moe_apply", saved[0]),
                                            ranged("moe._expert_ffn", saved[1]),
                                            ranged("layers.mlp", saved[2]))
    try:
        prompt = np.zeros((BATCH, GEN), np.int32)
        server.process(prompt)
        prof, _ = _device_profile("qwen2-moe stage", lambda _: server.process(prompt))
    finally:
        MO.moe_apply, MO._expert_ffn, ML.mlp = saved
    if prof is None:
        log(f"qwen2-moe stage: the profiler recorded no device kernel in {PROFILE_TRIES} "
            f"windows; MoE device time not measured")
        return
    parts, busy = {}, 0.0
    for e in prof.events():
        if not e.kernels:
            continue
        names, p = [], e
        while p is not None:
            names.append(p.name)
            p = p.cpu_parent
        part = ("expert products" if "moe._expert_ffn" in names else
                "shared experts" if "moe.moe_apply" in names and "layers.mlp" in names else
                "routing, dispatch and combine" if "moe.moe_apply" in names else None)
        for k in e.kernels:
            busy += k.duration / 1e3
            if part:
                parts.setdefault(part, {}).setdefault(k.name, [0, 0.0])
                parts[part][k.name][0] += 1
                parts[part][k.name][1] += k.duration / 1e3
    log(f"qwen2-moe stage, one served batch (B={BATCH}, prompt {GEN}, {GEN} decode steps): "
        f"device busy {busy:.3f} ms")
    for part, kernels in parts.items():
        total = sum(ms for _, ms in kernels.values())
        log(f"  MoE {part}: {total:.3f} ms, {total / busy:.4f} of the stage's busy time")
        for name, (calls, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:4]:
            log(f"    {ms:8.3f} ms {calls:5d} calls  {name[:90]}")
    assert parts.get("expert products"), parts


def phase_moe_dispatch_time():
    """One qwen2-moe MoE layer at its published widths (bf16, fresh weights
    from a seed) in each dispatch mode, by CUDA events, at the token counts
    of nlp-chain's decode step (B 4), its served prefill (B 4 x 8) and the
    kernel-vs-naive prefill (B 4 x 256): which mode is the faster where."""
    mcfg = configs.get_config("qwen2-moe-a2.7b").moe
    gen = torch.Generator(device=DEV).manual_seed(11)
    params = MO.init_moe(gen, 2048, mcfg, True, torch.bfloat16)
    with torch.inference_mode():
        for s in (1, GEN, QWEN_PROMPT):
            x = _randn(gen, (BATCH, s, 2048), torch.bfloat16)
            t = BATCH * s
            ms = {impl: cuda_ms(lambda x, i=impl: MO.moe_apply(params, x, mcfg, impl=i),
                                copies((x,)), iters=10)
                  for impl in ("einsum", "gather")}
            log(f"qwen2-moe MoE layer T={t} (capacity {MO._capacity(t, mcfg)}): einsum "
                f"{ms['einsum']:.4f} ms, gather {ms['gather']:.4f} ms")
    del params
    torch.cuda.empty_cache()


def phase_nlp_kernel_vs_naive(servers):
    """gemma3 (prompt 1280: windowed K1, the wrapped K2 ring) and qwen2-moe
    (prompt 256: T 1024, capacity 86) through the kernels and the naive
    paths, and qwen2-moe's einsum dispatch against its gather dispatch.  In
    bf16 on the served weights, greedy tokens where the margin allows,
    qwen2-moe's second run under the first run's routing (bf16 rounding
    flips near-tie routings in every request over 24 layers); in f32 on
    fresh weights at a cut depth (gemma3 6 layers, qwen2-moe 4, full
    width), the same routing in both runs and logits within 2e-4."""
    gemma, qwen = servers[0], servers[1]
    kern, naive = _kernel_and_naive_logits(gemma.config, gemma.params[gemma.active], NLP_PROMPT)
    _bf16_greedy_agreement(f"gemma3-27b full width {GEMMA_LAYERS} layers, S={NLP_PROMPT}",
                           kern, naive)
    for what, impls, moe_impls in (
            ("kernel vs naive", ("naive", "kernel"), ("einsum",) * 2),
            ("einsum vs gather", ("kernel",) * 2, ("gather", "einsum"))):
        ref, got = _kernel_and_naive_logits(qwen.config, qwen.params[qwen.active], QWEN_PROMPT,
                                            impls, moe_impls, replay=True)
        _bf16_greedy_agreement(f"qwen2-moe full width, S={QWEN_PROMPT}", got, ref,
                               what=f"{what} under the {impls[0]} {moe_impls[0]} run's routing")
    del kern, naive, ref, got
    for name, cfg, layers in (("gemma3-27b", gemma.config, GEMMA_F32_LAYERS),
                              ("qwen2-moe-a2.7b", qwen.config, QWEN_F32_LAYERS)):
        cfg32 = dataclasses.replace(cfg, n_layers=layers, dtype=torch.float32)
        params32 = M.init(cfg32, seed=8)
        prompt = NLP_PROMPT if cfg.sliding_window else QWEN_PROMPT
        runs = [("kernel vs naive", ("kernel", "naive"), ("einsum",) * 2)]
        if cfg.moe is not None:
            runs.append(("einsum vs gather", ("kernel",) * 2, ("einsum", "gather")))
        for label, impls, moe_impls in runs:
            a, b = _kernel_and_naive_logits(cfg32, params32, prompt, impls, moe_impls)
            _f32_agreement(f"{label} ({name} full width, {layers} layers, S={prompt})", a, b)
        del params32, a, b
        gc.collect()
        torch.cuda.empty_cache()


def phase_profile_nlp(qwen_server):
    """The reduced nlp-chain families through build_pipeline, and the
    full-width qwen2-moe stage, into StageModels."""
    t0 = time.perf_counter()
    pipe, engine = build_pipeline("nlp-chain", profile_batches=(1, 2, 4), verbose=False)
    for st in pipe.stages:
        log(f"profiled stage {st.name} (reduced f32 family): SLA {st.sla:.6f} s")
        for v in st.variants:
            log(f"  {v.name}: latency(1) {float(v.latency(1)) * 1e3:.4f} ms, "
                f"base_alloc {v.base_alloc}")
    out, lat = engine.serve(np.zeros((2, 16), np.int32))
    assert out.shape == (2, 4) and len(lat) == 3
    profs = PF.profile_stage_server(qwen_server, batches=(1, 2, 4))
    stage = PF.build_stage(qwen_server.name, profs, th=2.0, batch_choices=(1, 2, 4),
                           max_batch=4)
    for p in profs:
        log(f"profiled full-width {p.name}: batches {p.batches} latencies "
            f"{[f'{x * 1e3:.3f} ms' for x in p.latencies]}")
    for v in stage.variants:
        log(f"  {v.name}: latency(1) {float(v.latency(1)) * 1e3:.4f} ms, "
            f"base_alloc {v.base_alloc}; stage SLA {stage.sla:.6f} s")
    log(f"nlp-chain profile phase: {time.perf_counter() - t0:.1f} s; pipeline SLA_P "
        f"{pipe.sla:.6f} s")


def phase_jamba():
    """jamba-v0.1-52b at full width, one period of 8 layers: served as a
    one-stage pipeline (per batch K1 once, K2 once a decode step, K3 once
    per Mamba2 layer), then its kernel path against its naive path (prefill
    + 2 decode steps): bf16 on the served weights, f32 on fresh ones."""
    full = configs.get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    kinds = ["attention" if cfg.is_attn_layer(i) else "mamba2" for i in range(cfg.n_layers)]
    kinds = [k + (" + MoE" if cfg.is_moe_layer(i) else " + MLP") for i, k in enumerate(kinds)]
    log(f"jamba-v0.1-52b: full width (d {cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV "
        f"heads, d_ff {cfg.d_ff}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_ff "
        f"{cfg.moe.d_ff_expert}, d_state {cfg.ssm.d_state}), depth cut from {full.n_layers} to "
        f"one period of {cfg.n_layers}: {kinds}; {_gib(cfg):.2f} GiB (all {full.n_layers}: "
        f"{_gib(full):.2f} GiB)")
    n_ssm = sum(not cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    n_attn = cfg.n_layers - n_ssm
    server = StageServer("jamba-v0.1-52b", [("jamba-8L", cfg, _best_accuracy("jamba-v0.1-52b"))],
                         gen_tokens=GEN, max_ctx=JAMBA_PROMPT + GEN, seed=9)
    prompt = np.random.default_rng(9).integers(0, cfg.vocab, (BATCH, JAMBA_PROMPT)).astype(
        np.int32)
    server.process(prompt)
    out, lat = server.process(prompt)
    want = {"flash_attention": n_attn, "decode_attention": n_attn * GEN, "ssd_scan": n_ssm}
    launches = served_launches("jamba launches", lambda: server.process(prompt), want)
    log(f"served jamba batch B={BATCH} S={JAMBA_PROMPT}: tokens {out.tolist()}, latency "
        f"{lat * 1e3:.3f} ms; launches on the device {launches} (expected {want})")
    assert launches == want and out.shape == (BATCH, GEN), launches
    # the kernel path's launches over prefill + 2 decode steps, compared
    # with the naive path under the naive run's routing
    reset_launches()
    naive, kern = _kernel_and_naive_logits(cfg, server.params[server.active], JAMBA_PROMPT,
                                           ("naive", "kernel"), replay=True)
    step = read_launches()
    want_step = {"flash_attention": n_attn, "decode_attention": 2 * n_attn, "ssd_scan": n_ssm}
    log(f"jamba kernel path, prefill + 2 decode steps: launches {step} (expected {want_step})")
    assert step == want_step, step
    _bf16_greedy_agreement(f"jamba-v0.1-52b full width, {cfg.n_layers} layers, "
                           f"S={JAMBA_PROMPT}", kern, naive,
                           what="kernel vs naive under the naive path's routing")
    del server, kern, naive
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = M.init(cfg32, seed=10)
    kern, naive = _kernel_and_naive_logits(cfg32, params32, JAMBA_PROMPT)
    _f32_agreement(f"kernel vs naive (jamba-v0.1-52b full width, {cfg.n_layers} layers, "
                   f"S={JAMBA_PROMPT})", kern, naive, tol=MAMBA_TOL)
    return launches


# ---------------------------------------------------------------------------
# IPA's loop on the card's profiles
# ---------------------------------------------------------------------------
def _replay_record(res):
    """A TraceResult as plain values, its wall times left out."""
    return dict(summary=res.summary(),
                intervals=[dataclasses.astuple(dataclasses.replace(r, solve_time=0.0))
                           for r in res.intervals],
                latencies=res.latencies.tobytes(), arrived=res.arrived,
                completed=res.completed, dropped=res.dropped, sla=res.sla,
                sim_events=res.sim_events, peak_queue_depth=res.peak_queue_depth)


def phase_replay(pipe):
    """``replay`` on the vlm-classify PipelineModel profiled on the card, for
    every policy, on the launcher's defaults: the end-to-end metrics (mean
    PAS and cost over the 10 s intervals, SLA violation rate, p99 latency,
    dropped and completed requests), the simulator's events and the
    solver's host time.  A second ``ipa`` replay must agree with the first,
    and ``replay`` with ``run_trace`` called directly; then the launcher's
    ``main`` runs once (it profiles the families anew)."""
    t0 = time.perf_counter()
    defaults = {k: v for k, v in SV.replay.__kwdefaults__.items() if k != "policy"}
    rates = TR.excerpt(defaults["trace"], seconds=defaults["seconds"]) * defaults["scale_rps"]
    log(f"replay on the card-profiled vlm-classify (SLA_P {pipe.sla:.6f} s), {defaults}: "
        f"{len(rates)} s of rates, mean {rates.mean():.4f} rps, peak {rates.max():.4f} rps "
        f"{REPLICA_NOTE}")
    out = {}
    for policy in SV.POLICIES:
        res = SV.replay(pipe, policy=policy, **defaults)
        picks = sorted({(round(r.pas, 4), r.cost) for r in res.intervals})
        log(f"  {policy}: {json.dumps(res.summary())}; simulator events {res.sim_events}, "
            f"peak queue {res.peak_queue_depth}, solver_wall_s {res.solver_wall_s:.6f}; "
            f"{len(res.intervals)} intervals, {sum(not r.feasible for r in res.intervals)} "
            f"infeasible, (PAS, cost) chosen {picks} {REPLICA_NOTE}")
        assert res.completed + res.dropped <= res.arrived and res.completed > 0, res.summary()
        assert all(np.isfinite([r.pas, r.cost]).all() for r in res.intervals)
        out[policy] = res
    again = SV.replay(pipe, policy="ipa", **defaults)
    direct = AD.run_trace(pipe, rates, policy="ipa", seed=defaults["seed"],
                          obj=OPT.Objective(alpha=defaults["alpha"], beta=defaults["beta"],
                                            metric="pas"))
    same = _replay_record(again) == _replay_record(out["ipa"])
    agree = _replay_record(direct) == _replay_record(out["ipa"])
    log(f"  a second ipa replay agrees: {same}; replay agrees with run_trace: {agree}")
    assert same and agree
    log(f"replay phase: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    SV.main(["--seconds", "60"])
    log(f"launcher main --seconds 60: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# whisper: the encoder-decoder family
# ---------------------------------------------------------------------------
def _whisper_batch(cfg, seed):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    frames = _randn(gen, (BATCH, cfg.encoder_seq, cfg.d_model), cfg.dtype)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (BATCH, WHISPER_PROMPT)).astype(np.int64)).to(DEV)
    return toks, frames


def _whisper_generate(params, cfg, toks, frames):
    """What the engine does for a token stage, with the frames given:
    prefill, then GEN greedy decode steps.  Returns the generated tokens
    (B, GEN)."""
    with torch.inference_mode():
        hl, caches, s = M.prefill(params, cfg, {"tokens": toks, "frames": frames},
                                  capacity=toks.shape[1] + GEN)
        tok = torch.argmax(hl @ params["embed"].T, dim=-1)[:, None]
        out = []
        for i in range(GEN):
            out.append(tok)
            lg, caches = M.decode_step(params, cfg, caches, s + i, tok)
            tok = torch.argmax(lg, dim=-1)[:, None]
        gen = torch.cat(out, dim=1)
    torch.cuda.synchronize()
    return gen


def _whisper_logits(params, cfg, toks, frames, impl):
    """Prefill + 2 decode steps on the prompt's own tokens: logits (3, B, V)."""
    with torch.inference_mode():
        hl, caches, s = M.prefill(params, cfg, {"tokens": toks, "frames": frames}, impl=impl,
                                  capacity=toks.shape[1] + 2)
        lgs = [hl @ params["embed"].T]
        for step in range(2):
            lg, caches = M.decode_step(params, cfg, caches, s + step,
                                       toks[:, step:step + 1], impl=impl)
            lgs.append(lg)
    return torch.stack(lgs).float()


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_f32(v) for v in tree]
    return tree.float()


def _bf16_against_exact(label, kern, naive, exact):
    """bf16 logits of the kernel and naive paths, each against an f32
    evaluation of the same bf16 weights and inputs (``exact``).  At
    whisper's 48 bf16 layers either path's own rounding moves logits by
    about 0.06 from the exact values, so a greedy token whose top-2 margin
    lies between 2e-2 and that can come out either way in either path, and
    agreement at 2e-2 does not tell a kernel fault from rounding.  Held
    instead: the kernel path's mean distance from the exact logits is at
    most WHISPER_MEAN_RATIO times the naive path's (a fault in a kernel moves
    every position it touches, rounding does not), and its greedy tokens
    are the exact evaluation's wherever that margin exceeds twice the naive
    path's largest distance from it (the reference path's own error at
    this depth), which must hold somewhere."""
    tol = TOL[torch.bfloat16]
    dist = {k: ((t - exact).abs().max().item(), (t - exact).abs().mean().item())
            for k, t in (("kernel", kern), ("naive", naive))}
    floor = 2 * dist["naive"][0]
    top2 = exact.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > floor
    same = kern.argmax(-1) == exact.argmax(-1)
    (changed_k, n_tol), (changed_n, _) = (_greedy_changes(t, exact, tol) for t in (kern, naive))
    top2n = naive.topk(2, dim=-1).values
    clear_n = (top2n[..., 0] - top2n[..., 1]) > tol
    agree_kn = int((kern.argmax(-1) == naive.argmax(-1))[clear_n].sum())
    log(f"kernel and naive vs an f32 evaluation of the same weights ({label}, bf16, prefill + 2 "
        f"decode steps): max |logit diff| kernel {dist['kernel'][0]:.4e}, naive "
        f"{dist['naive'][0]:.4e}; mean kernel {dist['kernel'][1]:.4e}, naive "
        f"{dist['naive'][1]:.4e} (kernel at most {WHISPER_MEAN_RATIO} times naive); greedy "
        f"tokens of the kernel path agree with the f32 evaluation on {int(same[clear].sum())}/"
        f"{int(clear.sum())} positions whose top-2 margin exceeds {floor:.4e} (twice the naive "
        f"path's largest distance); at margin {tol}: kernel changes {changed_k}, naive "
        f"{changed_n} of {n_tol}, kernel vs naive agree on {agree_kn}/{int(clear_n.sum())} "
        f"(of {clear.numel()}); kernel vs naive max logit diff "
        f"{(kern - naive).abs().max().item():.4e}")
    assert torch.isfinite(kern).all()
    assert dist["kernel"][1] <= WHISPER_MEAN_RATIO * dist["naive"][1], dist
    assert bool(clear.any()) and bool(same[clear].all())


def phase_whisper():
    """whisper-medium at its published config, full depth: B 4, 1500
    frames, a 32-token prompt, 8 greedy tokens.  Per batch K1 runs once in
    every encoder layer and twice in every decoder layer (self-attention and
    cross-attention prefill), K2 twice in every decoder layer and decode
    step.  Then its kernel path against its naive path: in bf16 on these
    weights, each against an f32 evaluation of them (``_bf16_against_exact``);
    in f32 on fresh weights, logits within 2e-4."""
    cfg = configs.get_config("whisper-medium")
    log(f"whisper-medium: published config, {cfg.n_encoder_layers} encoder + {cfg.n_layers} "
        f"decoder layers, d {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, "
        f"hd {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.encoder_seq} frames; "
        f"{cfg.n_params() / 1e9:.3f} B params, {_gib(cfg):.2f} GiB of bf16 weights")
    t0 = time.perf_counter()
    params = M.init(cfg, seed=12, device=DEV)
    torch.cuda.synchronize()
    log(f"init: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    toks, frames = _whisper_batch(cfg, 12)
    _whisper_generate(params, cfg, toks, frames)        # first use
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = _whisper_generate(params, cfg, toks, frames)
        walls.append(time.perf_counter() - t0)
    launches = read_launches()
    want = {"flash_attention": 2 * (cfg.n_encoder_layers + 2 * cfg.n_layers),
            "decode_attention": 2 * 2 * cfg.n_layers * GEN, "ssd_scan": 0}
    log(f"served whisper batch B={BATCH} frames {cfg.encoder_seq} prompt {WHISPER_PROMPT}: tokens "
        f"{out.tolist()}; wall {[f'{w * 1e3:.3f} ms' for w in walls]}; launches over 2 batches "
        f"{launches} (expected {want}: per batch K1 {want['flash_attention'] // 2}, K2 "
        f"{2 * cfg.n_layers} a decode step); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    assert launches == want, launches
    assert out.shape == (BATCH, GEN) and bool(((out >= 0) & (out < cfg.vocab)).all())
    phase_trace(lambda: _whisper_generate(params, cfg, toks, frames), float(np.mean(walls)))

    kern, naive = (_whisper_logits(params, cfg, toks, frames, impl)
                   for impl in ("kernel", "naive"))
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = _to_f32(params)
    del params
    exact = _whisper_logits(params32, cfg32, toks, frames.float(), "naive")
    _bf16_against_exact(f"whisper-medium full depth, frames {cfg.encoder_seq}, "
                        f"S={WHISPER_PROMPT}", kern, naive, exact)
    del params32, kern, naive, exact
    gc.collect()
    torch.cuda.empty_cache()
    params32 = M.init(cfg32, seed=13, device=DEV)
    toks, frames = _whisper_batch(cfg32, 13)
    kern, naive = (_whisper_logits(params32, cfg32, toks, frames, impl)
                   for impl in ("kernel", "naive"))
    _f32_agreement(f"kernel vs naive (whisper-medium full depth, frames {cfg.encoder_seq}, "
                   f"S={WHISPER_PROMPT})", kern, naive)
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# enum: the planner's float32 enumeration on the card
# ---------------------------------------------------------------------------
def phase_enum(pipe):
    """``solve_enum`` (torch, float32, on the card) must pick what
    ``solve_vec`` and ``solve_brute`` pick on the card-profiled vlm-classify
    pipeline at each rate of phase planner."""
    t0 = time.perf_counter()
    obj = OPT.Objective(**PLANNER_OBJ)
    for lam in PLANNER_RPS:
        enum = OPT.solve_enum(pipe, lam, obj)
        vec, brute = OPT.solve_vec(pipe, lam, obj), OPT.solve_brute(pipe, lam, obj)
        agree = all(enum.feasible == s.feasible and enum.config == s.config
                    and enum.objective == s.objective for s in (vec, brute))
        log(f"  enum {lam:g} rps: solve_enum {_pick(enum)}, objective {enum.objective:.6f}, "
            f"{enum.solve_time * 1e3:.3f} ms on the card; agrees with solve_vec and "
            f"solve_brute: {agree} {REPLICA_NOTE}")
        assert agree, (lam, enum, vec, brute)
    log(f"enum phase: {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# predictor: the LSTM load predictor on the card, and Fig. 16's ablation
# ---------------------------------------------------------------------------
# benchmarks/run.py:221 (fig16, full mode): 400 steps, windows at stride 30
LSTM_STEPS, LSTM_STRIDE = 400, 30


class _ScaledPredictor:
    """An LSTM trained on the trace's own scale, for rates that are the
    trace's times ``scale`` (the launcher's ``--scale-rps``)."""

    def __init__(self, lstm, scale):
        self.lstm, self.scale = lstm, scale

    def predict(self, history):
        return self.scale * self.lstm.predict(np.asarray(history) / self.scale)


def _fig16(label, pipe, rates, obj, seed, lstm):
    """``run_trace`` under ``ipa`` with reactive, LSTM and oracle demand."""
    out = {}
    for name, kw in (("reactive", {}), ("lstm", dict(predictor=lstm)),
                     ("oracle", dict(oracle=PR.OraclePredictor(rates)))):
        res = AD.run_trace(pipe, rates, policy="ipa", obj=obj, seed=seed, **kw)
        err = np.mean([abs(r.lam_hat - r.lam_true) / r.lam_true for r in res.intervals])
        log(f"  fig16 {label} {name}: {json.dumps(res.summary())}; mean |lam_hat - lam_true| / "
            f"lam_true {err:.4f}; {len(res.intervals)} intervals")
        assert res.completed > 0 and np.isfinite([r.lam_hat for r in res.intervals]).all()
        out[name] = res.summary()
    return out


def phase_predictor(pipe):
    """The LSTM's forward on the card against the CPU (within 1e-5); its
    training on the 14-day train region (benchmarks/run.py's full fig16
    settings), its SMAPE on the test region at stride 200 (below 15, and no
    worse than persistence + 1: tests/test_predictor_trace.py:58-67); then
    Fig. 16's ablation on the paper's video pipeline (bursty 120 s, seed 7)
    and on the card-profiled vlm-classify pipeline (the launcher's replay)."""
    t0 = time.perf_counter()
    params = PR.init_lstm(torch.Generator().manual_seed(0))
    x = np.random.default_rng(3).standard_normal((128, PR.HISTORY)).astype(np.float32)
    want = PR.lstm_apply(params, torch.from_numpy(x))
    got = PR.lstm_apply({k: v.to(DEV) for k, v in params.items()}, torch.from_numpy(x).to(DEV))
    err = float((got.cpu() - want).abs().max())
    log(f"predictor: lstm_apply on the card vs the CPU, B 128 T {PR.HISTORY}: max abs err {err:.3e}")
    assert err <= 1e-5, err
    train = TR.train_region()
    t1 = time.perf_counter()
    lstm = PR.LSTMPredictor.train(train, steps=LSTM_STEPS, stride=LSTM_STRIDE, device=DEV)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    X, y = PR.make_windows(TR.test_region(), stride=200)
    s_lstm = PR.smape(lstm.predict_batch(X), y)
    s_last = PR.smape(X[:, -1], y)
    log(f"predictor: LSTM trained on {len(train)} s of trace ({LSTM_STEPS} steps, stride "
        f"{LSTM_STRIDE}) in {train_s:.3f} s (host clock, synchronised); SMAPE on the test "
        f"region {s_lstm:.4f}% against persistence {s_last:.4f}% ({len(y)} windows)")
    assert s_lstm < 15.0 and s_lstm <= s_last + 1.0, (s_lstm, s_last)
    video = PP.video()
    _fig16("video (paper profiles, bursty 120 s, seed 7)", video, TR.excerpt("bursty", 120),
           OPT.Objective(**PP.PAPER_WEIGHTS["video"], metric="pas"), 7, lstm)
    d = SV.replay.__kwdefaults__
    rates = TR.excerpt(d["trace"], seconds=d["seconds"]) * d["scale_rps"]
    _fig16(f"card-profiled vlm-classify ({d['trace']} {d['seconds']} s x {d['scale_rps']}, "
           f"seed {d['seed']}) {REPLICA_NOTE}", pipe, rates,
           OPT.Objective(alpha=d["alpha"], beta=d["beta"], metric="pas"), d["seed"],
           _ScaledPredictor(lstm, d["scale_rps"]))
    log(f"predictor phase: {time.perf_counter() - t0:.1f} s")
    return dict(train_s=train_s, smape=s_lstm, persistence=s_last)


# ---------------------------------------------------------------------------
# train: starcoder2-3b at its published config through the launcher
# ---------------------------------------------------------------------------
TRAIN_ARCH = "starcoder2-3b"
TRAIN_STEPS = 5
TRAIN_BATCH, TRAIN_SEQ = 8, 128          # the launcher's defaults
LEARN_STEPS = 120                        # tests/test_training_serving.py:22-28


def _grads(params, cfg, batch):
    leaves = OT.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = TT.loss_fn(params, cfg, batch, impl="naive")
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    flat = iter(grads)
    return loss.detach(), OT.tree_map(lambda _: next(flat), params)


def _timed_steps(step, params, state, batch, n=3):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    return times


def _train_full_width():
    cfg = configs.get_config(TRAIN_ARCH)
    log(f"train: {TRAIN_ARCH} at its published config (hf:bigcode/starcoder2-3b; "
        f"{cfg.n_layers} layers, d {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads; {cfg.n_params() / 1e9:.2f} B params, "
        f"{cfg.dtype}), B {TRAIN_BATCH} S {TRAIN_SEQ}, nothing cut")
    t0 = time.perf_counter()
    params, state, hist = LT.main(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                                   "--log-every", "1"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    for h in hist:
        log(f"  full-width step {h['step']}: loss {h['loss']:.6f}, grad norm "
            f"{h['grad_norm']:.6f}, lr {h['lr']:.3e}")
    assert len(hist) == TRAIN_STEPS
    assert all(np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist), hist
    ocfg = OT.AdamWConfig(lr=1e-3, warmup_steps=min(20, TRAIN_STEPS // 5),
                          total_steps=TRAIN_STEPS)
    step = TT.make_train_step(cfg, ocfg, impl="naive")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ)))
             .to(DEV) for k in ("tokens", "labels")}
    times = _timed_steps(step, params, state, batch)
    step_s = float(np.mean(times))
    prof, kernels = _device_profile("full-width train step", lambda attempt: step(params, state,
                                                                                   batch))
    share = "not measured"
    if kernels:
        busy = sum(e.self_device_time_total for e in kernels if e.key != "apply_updates")
        opt = max((e.device_time_total for e in prof.key_averages() if e.key == "apply_updates"),
                  default=0.0)
        share = f"{opt / busy:.4f} ({opt / 1e3:.3f} of {busy / 1e3:.3f} ms device time)"
    loss, grads = _grads(params, cfg, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    OT.apply_updates(params, grads, state, ocfg, decay=TT.decay_mask(params, cfg))
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t1
    log(f"train: {TRAIN_STEPS} launcher steps in {wall:.3f} s; step time {step_s * 1e3:.3f} ms "
        f"(host clock, synchronised, mean of 3: {[round(x * 1e3, 3) for x in times]}), "
        f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.1f} tokens/s; peak memory {peak:.3f} GiB "
        f"(torch.cuda.max_memory_allocated over the launcher's run); apply_updates share of "
        f"the step's device time (torch.profiler) {share}; apply_updates alone "
        f"{opt_s * 1e3:.3f} ms (host clock, synchronised), {opt_s / step_s:.4f} of a step")
    del params, state, grads, prof
    return dict(step_ms=step_s * 1e3, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
                peak_gib=peak, opt_share=share, opt_ms=opt_s * 1e3, hist=hist)


def _train_parity():
    """One step of reduced f32 starcoder2-3b on the card and on the CPU from
    the same params and batch: loss and gradients within 2e-4 (each leaf
    against its largest gradient; TF32 is off)."""
    cfg = configs.get_config(TRAIN_ARCH, reduced=True)
    cpu = M.init(cfg, seed=0, device="cpu")
    card = OT.tree_map(lambda p: p.to(DEV), cpu)
    batch = TD.SyntheticStream(cfg, TD.DataConfig(seq_len=64, batch_size=4)).batch(0)
    lc, gc_ = _grads(cpu, cfg, TD.to_device(batch, "cpu"))
    lg, gg = _grads(card, cfg, TD.to_device(batch, DEV))
    worst = max(float((g.cpu() - c).abs().max()) / max(float(c.abs().max()), 1e-30)
                for g, c in zip(OT.tree_leaves(gg), OT.tree_leaves(gc_)))
    log(f"train parity (reduced f32 {TRAIN_ARCH}, B 4 S 64): loss card {float(lg):.7f} cpu "
        f"{float(lc):.7f}; largest gradient difference {worst:.3e} of the leaf's largest")
    assert abs(float(lg) - float(lc)) < 2e-4 and worst < 2e-4, (float(lg), float(lc), worst)


def _train_learning():
    cfg = configs.get_config(TRAIN_ARCH, reduced=True)
    stream = TD.SyntheticStream(cfg, TD.DataConfig(seq_len=64, batch_size=8))
    t0 = time.perf_counter()
    _, _, hist = TT.train_loop(cfg, stream, LEARN_STEPS, log_every=20, verbose=False,
                               ocfg=OT.AdamWConfig(lr=1e-3, warmup_steps=10,
                                                   total_steps=LEARN_STEPS), device=DEV)
    log(f"train learning (reduced {TRAIN_ARCH}, {LEARN_STEPS} steps, B 8 S 64): losses "
        f"{[round(h['loss'], 4) for h in hist]} in {time.perf_counter() - t0:.1f} s")
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.2, hist


def _train_guard():
    """Each kernel's wrapper refuses inputs that require grad on the card,
    before launching."""
    gen = torch.Generator(device=DEV).manual_seed(0)

    def t(*shape):
        return _randn(gen, shape, torch.float32).requires_grad_(True)
    calls = {"flash_attention": lambda: ops.flash_attention(t(1, 8, 2, 32), t(1, 8, 2, 32),
                                                            t(1, 8, 2, 32)),
             "decode_attention": lambda: ops.decode_attention(
                 t(1, 2, 32), t(1, 8, 2, 32), t(1, 8, 2, 32),
                 torch.tensor([5], dtype=torch.int32, device=DEV)),
             "ssd_scan": lambda: ops.ssd_scan(t(1, 16, 2, 16), torch.rand(1, 16, 2, device=DEV),
                                              -torch.rand(2, device=DEV), t(1, 16, 1, 8),
                                              t(1, 16, 1, 8), chunk=16)}
    before = read_launches()
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            log(f"train guard: {name} refuses autograd on the card: {e}")
        else:
            raise AssertionError(f"{name} launched on inputs that require grad")
    assert read_launches() == before


def phase_train():
    t0 = time.perf_counter()
    out = _train_full_width()
    gc.collect()
    torch.cuda.empty_cache()
    _train_parity()
    _train_learning()
    _train_guard()
    log(f"train phase: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# mesh: the launcher's mesh path on a DeviceMesh of one card
# ---------------------------------------------------------------------------
MESH_TOL = 2e-2                          # bf16: tests/test_kernels.py:13-15
MESH_CKPT = ROOT / "build" / "chip_smoke_mesh" / "starcoder2-3b.npz"


def _free_port() -> int:
    with contextlib.closing(socket.socket()) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_mesh(train):
    """starcoder2-3b through the launcher's mesh path on the 1x1 mesh of an
    NCCL group of one rank, against phase train's plain path: the same
    arguments, each step's loss and grad norm within MESH_TOL relative; its
    step time (the same fixed batch as phase train's, placed on the mesh),
    tokens/s and peak memory beside phase train's; the launcher's checkpoint
    loaded back onto the mesh, bit for bit."""
    t0 = time.perf_counter()
    shutil.rmtree(MESH_CKPT.parent, ignore_errors=True)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        params, state, hist = LT.main(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                                       "--log-every", "1", "--save", str(MESH_CKPT)])
        wall = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated() / 2**30
        leaf = OT.tree_leaves(params)[0]
        mesh = leaf.device_mesh
        log(f"mesh: {TRAIN_ARCH} through launch.train on {mesh} (NCCL, one rank), "
            f"{TRAIN_STEPS} steps in {wall:.3f} s with the checkpoint; leaves are "
            f"{type(leaf).__name__}s, e.g. embed {tuple(params['embed'].placements)}")
        worst = 0.0
        for h, p in zip(hist, train["hist"], strict=True):
            rel = max(abs(h[k] - p[k]) / abs(p[k]) for k in ("loss", "grad_norm"))
            worst = max(worst, rel)
            log(f"  meshed step {h['step']}: loss {h['loss']:.6f} (plain {p['loss']:.6f}), "
                f"grad norm {h['grad_norm']:.6f} (plain {p['grad_norm']:.6f}), rel {rel:.3e}")
        assert worst <= MESH_TOL, worst
        cfg = configs.get_config(TRAIN_ARCH)
        t1 = time.perf_counter()
        back = CK.load(str(MESH_CKPT), cfg, device=DEV, mesh=mesh,
                       specs=LT.param_specs(params, cfg, mesh))
        load_s = time.perf_counter() - t1
        pairs = list(zip(OT.tree_leaves(params), OT.tree_leaves(back), strict=True))
        same = all(b.placements == a.placements and torch.equal(b.to_local(), a.to_local())
                   for a, b in pairs)
        size = MESH_CKPT.stat().st_size
        log(f"mesh checkpoint: {size / 2**30:.3f} GiB written by rank 0, loaded back onto "
            f"the mesh in {load_s:.3f} s; {len(pairs)} leaves equal bit for bit: {same}")
        assert same
        del back, pairs
        shutil.rmtree(MESH_CKPT.parent, ignore_errors=True)
        ocfg = OT.AdamWConfig(lr=1e-3, warmup_steps=min(20, TRAIN_STEPS // 5),
                              total_steps=TRAIN_STEPS)
        step = TT.make_train_step(cfg, ocfg, impl="naive")
        rng = np.random.default_rng(0)
        batch = TD.to_device({k: rng.integers(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ))
                              for k in ("tokens", "labels")}, DEV, mesh)
        with dapi.use_mesh(mesh):
            times = _timed_steps(step, params, state, batch)
        step_s = float(np.mean(times))
        log(f"mesh: step time {step_s * 1e3:.3f} ms (host clock, synchronised, mean of 3: "
            f"{[round(x * 1e3, 3) for x in times]}), {TRAIN_BATCH * TRAIN_SEQ / step_s:.1f} "
            f"tokens/s, peak memory {peak:.3f} GiB over the launcher's run; phase train's "
            f"plain path {train['step_ms']:.3f} ms, {train['tokens_per_s']:.1f} tokens/s, "
            f"{train['peak_gib']:.3f} GiB: DTensor's cost {step_s * 1e3 / train['step_ms']:.4f}x "
            f"the time, {peak / train['peak_gib']:.4f}x the peak")
        del params, state, batch
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"mesh phase: {time.perf_counter() - t0:.1f} s")
    return dict(step_ms=step_s * 1e3, peak_gib=peak, worst_rel=worst)


# the slow test that runs jamba's reduced step on a 2x2 gloo mesh of four
# processes on the host's CPU against the unsharded step
RANKS_TEST = "tests/test_torch_mesh_ranks.py::test_meshed_step_on_several_ranks[jamba-v0.1-52b]"


def phase_ranks():
    """RANKS_TEST under this host's torch: the Mamba2 gated norm's gradient
    on a mesh whose data axis shards the rows (``api.data_partial_grad``)
    and every other operation that the installed DTensor refuses only with
    several ranks; loss, grad norm and parameters within 2e-4 of the
    unsharded step."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-q", "-s",
                          "-p", "no:cacheprovider", "-m", "slow", RANKS_TEST],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=900)
    rec = [line for line in out.stdout.splitlines() if line.startswith("jamba")]
    log(f"ranks: {RANKS_TEST} on torch {torch.__version__} (gloo, CPU): exit "
        f"{out.returncode} in {time.perf_counter() - t0:.1f} s; {rec}; "
        f"{out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ''}")
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])


# ---------------------------------------------------------------------------
# dryrun: the meta-tensor dry run, its count held against the card, and the
# control-plane examples on the card
# ---------------------------------------------------------------------------
SWEEP_DIR = ROOT / "build" / "chip_smoke_dryrun"
PROBE_ARCH, PROBE_SHAPE = "yi-34b", "decode_32k"
# PyTorch's caching allocator rounds a block up to 512 bytes, keeps a large
# block whole where splitting it would leave at most 1 MiB, and rounds a
# new segment up to 2 MiB: a tensor may hold up to 2 MiB more than its bytes
ALLOC_SLACK = 2 << 20
# the decode step's transients: one token's activations, the logits (B x V
# in bf16, 16 MB at yi-34b) and K2's split workspace; keeping a copy of one
# layer's cache would add 16 GiB
PEAK_OVER_ARGS = 1 << 30


def _dryrun_sweep():
    """Every dry-run pair on the 16x16 production mesh (``dryrun --all``,
    meta tensors only, the card untouched), each case's record read back
    from the sweep's output."""
    t0 = time.perf_counter()
    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = DR.main(["--all", "--out", str(SWEEP_DIR)])
    out = buf.getvalue()
    pairs = configs.all_dryrun_pairs()
    recs = [json.loads((SWEEP_DIR / f"{a}__{s.name}__singlepod__einsum.json").read_text())
            for a, s in pairs]
    for r in recs:
        if not r["ok"]:
            log(f"dryrun {r['arch']} x {r['shape']} FAILED: {r['error']}\n{r['traceback']}")
            continue
        log(f"dryrun {r['arch']} x {r['shape']} ({r['mesh']}): {r['params'] / 1e9:.3f} B "
            f"params, arguments {r['mem']['argument_gb']:.4f} GiB a device, counted "
            f"{r['counted_flops_per_dev']:.4e} FLOP a device (model "
            f"{r['model_flops_per_dev']:.4e}), compute_s {r['compute_s']:.4e}, "
            f"counted_memory_s {r['counted_memory_s']:.4e}, collective "
            f"{r['collective_bytes_per_dev']:.4e} B a device, collective_s "
            f"{r['collective_s']:.4e}: {r['counted_bottleneck']}-bound by the counts "
            f"({r['total_s']} s)")
        if r["arch"] == PROBE_ARCH and r["shape"] in ("decode_32k", "train_4k"):
            log(f"  collectives of {r['arch']} x {r['shape']} by kind (B a device): "
                f"{ {k: r['collectives'][k] for k in DR.KINDS} }; counts "
                f"{r['collectives']['_counts']}; by axis {r['collectives']['_by_axis']}; "
                f"links {r['link_bw']}")
    n_ok = sum(r["ok"] and r["collective_bytes_per_dev"] is not None
               and r["collective_s"] is not None for r in recs)
    log(f"dryrun sweep: {out.strip().splitlines()[-1]}, exit {rc}; "
        f"{sum(r['total_s'] for r in recs):.1f} s of cases, {time.perf_counter() - t0:.1f} s "
        f"in all (counts on meta tensors over NVIDIA's data-sheet peaks)")
    assert rc == 0 and n_ok == len(pairs) == 35, (rc, n_ok)
    return recs


def _probe_on_card(k, shape, mesh):
    """The k-block probe of yi-34b x decode_32k built on the card with K2 on
    its path: the allocator's bytes for its arguments against the dry run's
    count, the step's peak over them, its device time."""
    cfg = DR._probe_cfg(configs.get_config(PROBE_ARCH), k)
    meta = DR.build_case(cfg, shape, mesh)
    count = DR.sharded_bytes(meta.arg_shapes, meta.arg_specs, mesh)
    _, counted_bytes = DR.count(meta)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    case = DR.build_case(cfg, shape, mesh, impl="kernel", device=DEV)
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated() - base
    leaves = OT.tree_leaves(case.args)
    storage = sum(t.untyped_storage().nbytes() for t in leaves)
    kv = sum(t.untyped_storage().nbytes() for c in case.args[1] for t in c.values())
    emb = case.args[0]["embed"].untyped_storage().nbytes()
    layers = sum(t.untyped_storage().nbytes() for t in OT.tree_leaves(case.args[0]["stack"]))
    log(f"dryrun probe {k} block(s) of {PROBE_ARCH} x {PROBE_SHAPE} on the card: dry-run "
        f"arguments {count / 2**30:.4f} GiB ({count} B: KV cache {kv / 2**30:.4f}, embedding "
        f"{emb / 2**30:.4f}, layer weights {layers / 2**30:.4f}); tensors "
        f"{storage} B; allocator {alloc} B ({len(leaves)} tensors, {alloc - storage} B over)")
    # the count holds the reference's int32 position argument, which the
    # port passes as a Python int
    assert storage == count - 4, (storage, count)
    assert 0 <= alloc - storage <= ALLOC_SLACK * len(leaves), (alloc, storage)
    with torch.no_grad():
        logits, _ = case.fn(*case.args)               # first use: cuBLAS handles
        del logits
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        logits, _ = case.fn(*case.args)
        torch.cuda.synchronize()
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() - base - alloc
        assert logits.shape == (shape.global_batch, cfg.vocab) and bool(
            torch.isfinite(logits.float()).all())
        del logits
        step_ms, source = _step_device_ms(f"dryrun probe {k} block(s)", case, k)
    log(f"dryrun probe {k}: peak over the arguments {peak / 2**20:.1f} MiB (limit "
        f"{PEAK_OVER_ARGS >> 20} MiB); launches {launches}; device time a step "
        f"{step_ms:.4f} ms ({source}); dry-run counted bytes {counted_bytes:.4e}")
    assert peak <= PEAK_OVER_ARGS, peak
    assert launches["decode_attention"] == k, launches
    del case
    gc.collect()
    torch.cuda.empty_cache()
    return dict(argument_bytes=count, allocator_bytes=alloc, peak_over_args=peak,
                step_ms=step_ms, source=source, counted_bytes=counted_bytes, launches=launches)


def _step_device_ms(label, case, k2_per_step, reps=3):
    """A step's device time: the device kernels ``torch.profiler`` records
    over ``reps`` steps, in a window that recorded K2 ``k2_per_step`` times
    a step (up to PROFILE_TRIES windows of the same size; a window's kernels
    are not a whole number a step: on the H100 two more each window); where
    none does, CUDA events over ``reps`` steps (launch gaps included), and
    the source says so."""
    def run(_):
        for _ in range(reps):
            case.fn(*case.args)

    def complete(kernels):
        return sum(e.count for e in kernels if "decode_split" in e.key) == k2_per_step * reps
    _, kernels = _device_profile(label, run, complete)
    if kernels:
        return sum(e.self_device_time_total for e in kernels) / 1e3 / reps, "torch.profiler"
    return (cuda_ms(lambda *a: case.fn(*a), [case.args], iters=reps),
            "CUDA events: no complete profiler window")


def _printed(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


def phase_dryrun():
    """The dry run's sweep over every pair on the production mesh (all ok),
    run here after the timed phases, then the yi-34b decode_32k probes on a
    1x1 mesh built for real on the card with K2 on their path (B 128 over
    32768 of 32768 slots): the
    allocator's bytes for the arguments within ALLOC_SLACK a tensor of the
    count, the step's peak at most PEAK_OVER_ARGS past them, and the device
    time a block beside the dry run's counted_memory_s for one block; then
    ``adaptability`` on the card line for line as with ``--device cpu``, and
    ``quickstart``."""
    t0 = time.perf_counter()
    _dryrun_sweep()
    shape = configs.INPUT_SHAPES[PROBE_SHAPE]
    mesh = MeshShape(("data", "model"), (1, 1))
    probes = {k: _probe_on_card(k, shape, mesh) for k in (1, 2)}
    block_ms = probes[2]["step_ms"] - probes[1]["step_ms"]
    block_bytes = probes[2]["counted_bytes"] - probes[1]["counted_bytes"]
    kv_block = 2 * shape.global_batch * shape.seq_len * 8 * 128 * 2
    log(f"dryrun: {PROBE_ARCH} x {PROBE_SHAPE}, one block: the card's device time "
        f"{block_ms:.4f} ms (2-block minus 1-block step; {probes[1]['source']}, "
        f"{probes[2]['source']}); the dry run's counted_memory_s "
        f"{block_bytes / DR.HBM_BW * 1e3:.4f} ms ({block_bytes:.4e} counted bytes of the "
        f"chunked path on meta, over {DR.HBM_BW:.3g} B/s); K2's bound on its "
        f"{kv_block / 1e9:.2f} GB of K and V {kv_block / PEAK_BYTES * 1e3:.4f} ms")
    t1 = time.perf_counter()
    card = _printed(adaptability.main, [])
    cpu = _printed(adaptability.main, ["--device", "cpu"])
    for line in card:
        log(f"  adaptability (card): {line}")
    assert card == cpu and len(card) == 16, (card, cpu)
    log(f"adaptability: the card's table equals the CPU's, {len(card)} lines "
        f"({time.perf_counter() - t1:.1f} s both)")
    lines = _printed(quickstart.main, [])
    for line in lines[-4:]:
        log(f"  quickstart: {line}")
    log(f"dryrun phase: {time.perf_counter() - t0:.1f} s")
    return {name: sum(p["launches"][name] for p in probes.values())
            for name in ("flash_attention", "decode_attention", "ssd_scan")}


def main() -> int:
    t0 = time.perf_counter()
    smi = phase_device()
    hmma = phase_build()
    parity = phase_parity()
    times = phase_timing()
    servers, launches, lats = phase_serve()
    phase_trace(lambda e=PipelineEngine(servers): e.serve(np.zeros((BATCH, PROMPT), np.int32)),
                float(np.mean([sum(lat) for lat in lats])))
    phase_kernel_vs_naive(servers[0])
    pipe = phase_profile(servers[0])
    phase_planner(pipe)
    phase_enum(pipe)
    phase_replay(pipe)
    phase_predictor(pipe)
    del servers
    gc.collect()
    torch.cuda.empty_cache()
    mamba, m_launches, m_lats = phase_serve_mamba()
    phase_trace(lambda: mamba.process(np.zeros((BATCH, MAMBA_PROMPT), np.int32)),
                float(np.mean([lat[0] for lat in m_lats])))
    phase_mamba_kernel_vs_naive(mamba)
    phase_profile_mamba(mamba)
    del mamba
    gc.collect()
    torch.cuda.empty_cache()
    nlp, n_launches, n_lats = phase_serve_nlp()
    phase_trace(lambda e=PipelineEngine(nlp): e.serve(np.zeros((BATCH, NLP_PROMPT), np.int32)),
                float(np.mean([sum(lat) for lat in n_lats])))
    phase_moe_time(nlp[1])
    phase_moe_dispatch_time()
    phase_nlp_kernel_vs_naive(nlp)
    phase_profile_nlp(nlp[1])
    del nlp
    gc.collect()
    torch.cuda.empty_cache()
    j_launches = phase_jamba()
    gc.collect()
    torch.cuda.empty_cache()
    w_launches = phase_whisper()
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train()
    gc.collect()
    torch.cuda.empty_cache()
    phase_mesh(train)
    phase_ranks()
    d_launches = phase_dryrun()
    # each kernel's launches: the sum over the paths' runs, the served
    # paths' counted on the device in a profiler trace, the others' by the
    # wrappers' counters, read from zero just before a run and just after
    by_path = {"vlm-classify": launches, "mamba2": m_launches, "nlp-chain": n_launches,
               "jamba": j_launches, "whisper": w_launches, "dryrun": d_launches}
    log(f"launches by served path: {by_path}")
    sources = {"flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:71", "phi-3 prefill"),
               "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:60", "phi-3 decode"),
               "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                            "src/repro/kernels/ssd_scan.py:70", "mamba2-2.7b prefill")}
    kernels = []
    for name, (source, replaces, shape) in sources.items():
        t = times[(name, shape)]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": sum(p[name] for p in by_path.values()),
                        "launches_by_path": {k: p[name] for k, p in by_path.items()},
                        "max_abs_err": t["max_abs_err"],
                        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                        "shape": shape, "f32_ms": t.get("f32_ms"),
                        "device_ms": t.get("device_ms"),
                        "hmma_in_library": hmma[name][0], "parity": parity[name]})
    log(f"total: {time.perf_counter() - t0:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
