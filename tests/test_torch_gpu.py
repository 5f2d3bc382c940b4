"""The port on the card: each CUDA kernel against its plain PyTorch version
(K1 with Sq != Sk too), the model and engine paths through the kernels
against the naive path (reduced whisper's encoder-decoder included), the
MoE layer's two dispatch modes against each other at full width, and the
engine's CUDA graphs of the decode step against the eager step.

Every test is marked ``gpu`` and skips inside the test where there is no
CUDA device.  The file imports neither jax nor the reference package, so it
runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerances are the reference's: 2e-4 for f32, 2e-2 for bf16; the SSD scan
in f32 takes the reference's own SSD tolerance (atol 5e-4, rtol 5e-3,
tests/test_kernels.py): the kernel's cumsum adds in another order than
torch.cumsum, and a difference of two cums near 2900 carries a few 1e-4 of
absolute error into exp, and the Mamba model paths the reference's Mamba
layer tolerance (atol 1e-3, rtol 1e-2).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import decode_attention as K2
from repro_torch.kernels import flash_attention as K1
from repro_torch.kernels import ssd_scan as K3
from repro_torch.models import model as M
from repro_torch.models import moe as MO
from repro_torch.serving.engine import StageServer

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(atol=2e-4, rtol=2e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
SSD_TOL = {torch.float32: dict(atol=5e-4, rtol=5e-3),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
MAMBA_TOL = dict(atol=1e-3, rtol=1e-2)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _randn(seed, shape, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to("cuda", dtype)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **TOL[dtype])


# (b, s, h, kv, hd, window, causal, dtype): ragged S, GQA group 7, hd 32..128
FLASH = [
    (2, 20, 4, 2, 32, None, True, torch.float32),
    (1, 16, 7, 1, 64, None, True, torch.float32),
    (1, 130, 2, 2, 96, 8, True, torch.float32),
    (2, 64, 4, 2, 128, None, False, torch.float32),
    (1, 33, 14, 2, 128, None, True, torch.bfloat16),
    (2, 200, 4, 4, 96, 70, True, torch.bfloat16),
    (1, 65, 8, 2, 64, 1, True, torch.bfloat16),
    (4, 512, 56, 8, 128, None, True, torch.bfloat16),
    (4, 500, 32, 32, 96, 64, True, torch.bfloat16),
]
# nlp-chain: gemma3's local layers (window 1024, group 2; at S 1100 the
# window's edge falls inside a tile), its global layers, qwen2-moe's prefill
FLASH += [(4, s, 32, 16, 128, 1024, True, dt) for s in (1280, 1100)
          for dt in (torch.bfloat16, torch.float32)]
FLASH += [(4, 1280, 32, 16, 128, None, True, torch.bfloat16),
          (4, 256, 16, 16, 128, None, True, torch.bfloat16),
          (4, 8, 16, 16, 128, None, True, torch.bfloat16)]
# jamba's attention layer: prompt 256, group 4, hd 128
FLASH += [(4, 256, 32, 8, 128, None, True, dt) for dt in (torch.bfloat16, torch.float32)]
# whisper-medium's encoder: non-causal over 1500 frames (23 tiles of 64 and
# a ragged 28), 16 heads of hd 64
FLASH += [(4, 1500, 16, 16, 64, None, False, dt) for dt in (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("b,s,h,kv,hd,window,causal,dtype", FLASH)
def test_flash_kernel_matches_plain(b, s, h, kv, hd, window, causal, dtype):
    _need_cuda()
    q = _randn(0, (b, s, h, hd), dtype)
    k, v = _randn(1, (b, s, kv, hd), dtype), _randn(2, (b, s, kv, hd), dtype)
    n = K1.flash_attention.launches
    got = K1.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert K1.flash_attention.launches == n + 1
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, K1.flash_attention_plain(q, k, v, causal=causal, window=window), dtype)


# Sq != Sk: (b, sq, sk, h, kv, hd, window, causal, dtype).  whisper's
# cross-attention prefill (a 32-token prompt over 1500 frames, non-causal);
# causal both ways at ragged sizes, positions counted from 0 on both sides;
# windowed, where from row 85 on (Sq 200 over Sk 70, window 16) a row sees
# no key and the reference weighs every key alike
FLASH_SQ_SK = [(4, 32, 1500, 16, 16, 64, None, False, dt)
               for dt in (torch.bfloat16, torch.float32)]
FLASH_SQ_SK += [(2, sq, sk, 4, 2, 64, None, causal, dt)
                for sq, sk in ((37, 150), (150, 37)) for causal in (True, False)
                for dt in (torch.bfloat16, torch.float32)]
FLASH_SQ_SK += [(2, 200, 70, 4, 2, 128, 16, True, dt) for dt in (torch.bfloat16, torch.float32)]
FLASH_SQ_SK += [(1, 130, 300, 8, 2, 96, 64, True, torch.bfloat16)]


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,window,causal,dtype", FLASH_SQ_SK)
def test_flash_kernel_sq_ne_sk_matches_plain(b, sq, sk, h, kv, hd, window, causal, dtype):
    _need_cuda()
    q = _randn(40, (b, sq, h, hd), dtype)
    k, v = _randn(41, (b, sk, kv, hd), dtype), _randn(42, (b, sk, kv, hd), dtype)
    n = K1.flash_attention.launches
    got = K1.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert K1.flash_attention.launches == n + 1
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, K1.flash_attention_plain(q, k, v, causal=causal, window=window), dtype)


# (b, L, h, kv, hd, lengths, dtype): ragged L; lengths 0, L and past L
DECODE = [
    (3, 20, 8, 2, 32, [0, 20, 7], torch.float32),
    (2, 20, 7, 1, 96, [1, 13], torch.float32),
    (3, 130, 4, 4, 64, [129, 300, 64], torch.float32),
    (2, 33, 14, 2, 128, [33, 0], torch.bfloat16),
    (4, 520, 56, 8, 128, [0, 520, 17, 300], torch.bfloat16),
    (4, 520, 32, 32, 96, [1, 64, 65, 519], torch.float32),
]
# the split cache: at B 7 and L 200 the wrapper's plan cuts 64-slot splits,
# so the lengths are 0, 1, a split edge -1, +0, +1, L and beyond L
SPLIT_EDGES = [0, 1, 63, 64, 65, 200, 300]
DECODE += [(7, 200, h, kv, hd, SPLIT_EDGES, dt)
           for h, kv, hd in ((2, 2, 32), (4, 4, 96), (14, 2, 128), (16, 2, 64), (8, 1, 32))
           for dt in (torch.float32, torch.bfloat16)]
# L of 1, 64, 65 and 4096 (B 1: 4, 16 or 64 splits), GQA groups 1, 7, 8, 12
# (two row chunks of the CUDA-core kernel) and 20 (two of the tensor cores')
DECODE += [(b, L, h, kv, hd, lengths, dt)
           for b, L, h, kv, hd, lengths in (
               (2, 1, 4, 4, 64, [0, 1]), (2, 1, 14, 2, 128, [1, 5]),
               (3, 64, 8, 1, 96, [63, 64, 0]), (3, 65, 7, 1, 128, [64, 65, 1]),
               (1, 4096, 32, 32, 96, [4000]), (1, 4096, 32, 32, 96, [257]),
               (1, 4096, 56, 8, 128, [4096]), (1, 4096, 8, 1, 64, [0]),
               (2, 300, 24, 2, 128, [299, 65]), (2, 100, 20, 1, 64, [50, 0]))
           for dt in (torch.float32, torch.bfloat16)]
# nlp-chain: gemma3's wrapped 1024-slot ring (every slot valid) and its
# global cache of 1288 slots (group 2), qwen2-moe's cache of 16 (group 1)
DECODE += [(4, L, h, kv, 128, lengths, dt)
           for L, h, kv, lengths in ((1024, 32, 16, [1024] * 4),
                                     (1288, 32, 16, [1281, 1288, 1283, 1285]),
                                     (16, 16, 16, [9, 16, 10, 13]))
           for dt in (torch.float32, torch.bfloat16)]
# jamba's cache of 264 slots (prompt 256 + 8), group 4
DECODE += [(4, 264, 32, 8, 128, [257, 264, 1, 130], dt)
           for dt in (torch.float32, torch.bfloat16)]
# whisper-medium's cross-attention decode: every request over all 1500
# frames, 16 heads of hd 64
DECODE += [(4, 1500, 16, 16, 64, [1500] * 4, dt) for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("b,L,h,kv,hd,lengths,dtype", DECODE)
def test_decode_kernel_matches_plain(b, L, h, kv, hd, lengths, dtype):
    _need_cuda()
    q = _randn(3, (b, h, hd), dtype)
    k, v = _randn(4, (b, L, kv, hd), dtype), _randn(5, (b, L, kv, hd), dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    n = K2.decode_attention.launches
    got = K2.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert K2.decode_attention.launches == n + 1
    _close(got, K2.decode_attention_plain(q, k, v, lens), dtype)


def test_decode_repeated_and_alternating_calls_match_plain():
    """The arrival counters reset: the same shape five times with new
    lengths each time, then two shapes in turn, every output against the
    plain version, and every counter zero at the end."""
    _need_cuda()
    shapes = [(4, 264, 32, 32, 96, torch.bfloat16), (4, 520, 56, 8, 128, torch.bfloat16),
              (2, 300, 8, 2, 64, torch.float32)]
    calls = [shapes[0]] * 5 + [shapes[1], shapes[2]] * 3 + [shapes[1], shapes[0]]
    for i, (b, L, h, kv, hd, dtype) in enumerate(calls):
        q = _randn(30 + i, (b, h, hd), dtype)
        k, v = _randn(50 + i, (b, L, kv, hd), dtype), _randn(70 + i, (b, L, kv, hd), dtype)
        lens = torch.tensor([(37 * i + 61 * j) % (L + 20) for j in range(b)],
                            dtype=torch.int32, device="cuda")
        got = K2.decode_attention(q, k, v, lens)
        _close(got, K2.decode_attention_plain(q, k, v, lens), dtype)
    torch.cuda.synchronize()
    assert all(int(c.abs().sum()) == 0 for c in K2._counters.values())


# bf16 edge cases of the tensor-core kernel's 64-row tiles: S around the
# tile edges, hd 96 and 128, GQA groups 1 and 7, a window of 64 that
# crosses tile edges
FLASH_EDGE = [(s, hd, h, kv, None) for s in (1, 8, 15, 17, 63, 65, 127, 129)
              for hd, h, kv in ((96, 4, 4), (128, 14, 2))]
FLASH_EDGE += [(s, hd, h, kv, 64) for s in (65, 129, 200)
               for hd, h, kv in ((96, 4, 4), (128, 14, 2))]


@pytest.mark.parametrize("s,hd,h,kv,window", FLASH_EDGE)
def test_flash_bf16_tile_edges_match_plain(s, hd, h, kv, window):
    _need_cuda()
    dtype = torch.bfloat16
    q = _randn(20, (2, s, h, hd), dtype)
    k, v = _randn(21, (2, s, kv, hd), dtype), _randn(22, (2, s, kv, hd), dtype)
    got = K1.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    _close(got, K1.flash_attention_plain(q, k, v, window=window), dtype)


def test_wrappers_refuse_before_launching():
    _need_cuda()
    q = torch.zeros((1, 8, 4, 48), device="cuda")
    n = K1.flash_attention.launches
    with pytest.raises(ValueError):
        K1.flash_attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    assert K1.flash_attention.launches == n


@pytest.mark.parametrize("arch,d_model", [("yi-34b", 256), ("phi-3-vision-4.2b", 384),
                                          ("starcoder2-3b", 128), ("gemma3-27b", 128)])
def test_model_kernel_path_matches_naive_path(arch, d_model):
    """Prefill past the window and decode across it, f32."""
    _need_cuda()
    cfg = configs.arch_module(arch).reduced(2, d_model)
    params = M.init(cfg, seed=0)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 74))).cuda()
    out = {}
    with torch.inference_mode():
        for impl in ("kernel", "naive"):
            hl, caches, s = M.prefill(params, cfg, {"tokens": toks[:, :66]}, impl=impl,
                                      capacity=74)
            lgs = [hl @ params["embed"].T]
            for t in range(66, 74):
                lg, caches = M.decode_step(params, cfg, caches, t, toks[:, t:t + 1], impl=impl)
                lgs.append(lg)
            out[impl] = torch.stack(lgs)
    _close(out["kernel"], out["naive"], torch.float32)


def test_whisper_kernel_path_matches_naive_path():
    """Reduced whisper, f32: the encoder, the decoder's self- and
    cross-attention prefill (Sq 12 over Sk 48) and 4 decode steps through
    the kernels, against the naive path; K1 runs 3 times a layer pair in
    prefill and K2 twice a layer in every decode step."""
    _need_cuda()
    cfg = configs.get_config("whisper-medium", reduced=True)
    params = M.init(cfg, seed=0)
    rng = np.random.default_rng(12)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))).cuda()
    frames = torch.from_numpy(rng.standard_normal(
        (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).cuda()
    out = {}
    with torch.inference_mode():
        for impl in ("kernel", "naive"):
            n1, n2 = K1.flash_attention.launches, K2.decode_attention.launches
            hl, caches, s = M.prefill(params, cfg, {"tokens": toks[:, :12], "frames": frames},
                                      impl=impl, capacity=16)
            lgs = [hl @ params["embed"].T]
            for t in range(12, 16):
                lg, caches = M.decode_step(params, cfg, caches, t, toks[:, t:t + 1], impl=impl)
                lgs.append(lg)
            out[impl] = torch.stack(lgs)
            launched = (K1.flash_attention.launches - n1, K2.decode_attention.launches - n2)
            assert launched == ((cfg.n_encoder_layers + 2 * cfg.n_layers, 8 * cfg.n_layers)
                                if impl == "kernel" else (0, 0)), launched
    _close(out["kernel"], out["naive"], torch.float32)


# each kernel wrapper's device kernels, by a piece of their names: K1 and
# K2 run one kernel a call, K3 a chain that ends in its output kernel
# (``ssd_kernel`` alone in f32)
PORT_KERNELS = {"flash_attention": ("::flash_kernel", "::flash_tc_kernel"),
                "decode_attention": ("::decode_split_",),
                "ssd_scan": ("::ssd_kernel", "::ssd_out_kernel")}


def _device_launches(fn):
    """``fn()``'s result and each wrapper's kernels that ran on the device
    in it, counted by name in a torch.profiler trace: the wrappers'
    ``launches`` count their calls, and a replayed CUDA graph calls none."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA
             and not e.is_user_annotation()]
    return out, {k: sum(any(p in n for p in pats) for n in names)
                 for k, pats in PORT_KERNELS.items()}


def test_engine_runs_the_kernels():
    _need_cuda()
    fam = configs.get_variant_family("yi-34b")[:1]
    srv = StageServer("yi-34b", fam, gen_tokens=3)
    srv.process(np.zeros((2, 16), np.int32))
    (out, lat), launched = _device_launches(
        lambda: srv.process(np.arange(32, dtype=np.int32).reshape(2, 16)))
    layers = fam[0][1].n_layers
    assert launched == {"flash_attention": layers, "decode_attention": 3 * layers,
                        "ssd_scan": 0}
    assert out.shape == (2, 3) and lat > 0


def test_every_device_op_of_a_call_was_launched_inside_its_stage_span():
    """torch.profiler with device activity only over one stage call of a
    reduced jamba (K1, K2, K3 and MoE) with the program's recorder on:
    every device operation has the runtime launch of its correlation id,
    at a host time inside the call's ``stage`` span.  The spans are on
    ``time.time_ns``, so this holds only where the profiler's host clock is
    that one: joining device time to the program's spans rests on it.  The
    tokens equal those of the call with the recorder off."""
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    cfg = configs.get_config("jamba-v0.1-52b", reduced=True)
    srv = StageServer("jamba", [("jamba", cfg, 0.0)], gen_tokens=3, max_ctx=48)
    prompt = np.arange(80, dtype=np.int32).reshape(2, 40)
    off, _ = srv.process(prompt)
    # the profiler closes first: the recording's end reads its device
    # counters, a copy launched after the stage
    with tracing.recording() as rec:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            on, _ = srv.process(prompt)
    np.testing.assert_array_equal(on, off)
    (at,) = [i for i, sp in enumerate(rec.spans) if sp.name == "stage"]
    stage = rec.spans[at]
    cuda = torch.autograd.DeviceType.CUDA
    launch, ops = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                ops.append((e.name(), e.correlation_id()))
        elif e.correlation_id():
            launch[e.correlation_id()] = e.start_ns()
    assert len(ops) > 50, ops
    outside = [(n, launch.get(c)) for n, c in ops
               if not stage.start_ns <= launch.get(c, -1) < stage.end_ns]
    assert not outside, (stage.start_ns, stage.end_ns, outside[:5])
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    # the decode steps replay a CUDA graph, which counts nothing: the
    # prefill's 40 tokens are routed
    assert rec.counters["moe.pairs"] == n_moe * 2 * cfg.moe.top_k * 40
    assert sum(sp.name == "decode" and sp.parent == at for sp in rec.spans) == 3


def _eager_tokens(srv, prompt):
    """What ``srv`` serves for ``prompt`` from an eager loop of
    ``M.decode_step`` on its active variant."""
    cfg, params = srv.config, srv.params[srv.active]
    b, s = prompt.shape
    toks = torch.from_numpy(prompt % cfg.vocab).cuda()
    with torch.inference_mode():
        hl, caches, _ = M.prefill(params, cfg, {"tokens": toks},
                                  capacity=min(srv.max_ctx, s + srv.gen_tokens))
        tok = torch.argmax(hl @ params["embed"].T, dim=-1)[:, None]
        out = []
        for i in range(srv.gen_tokens):
            out.append(tok)
            lg, caches = M.decode_step(params, cfg, caches, s + i, tok)
            tok = torch.argmax(lg, dim=-1)[:, None]
    return torch.cat(out, dim=1).int().cpu().numpy()


@pytest.mark.parametrize("arch", ["yi-34b", "jamba-v0.1-52b"])
def test_decode_graphs_serve_the_eager_loop_s_tokens(arch):
    """Reduced, bf16, two variants in one server: batches of 1 to 8 (every
    size the benchmark's cells form), back to back with new prompts (the
    static caches overwritten), smaller after larger, and a
    ``set_variant`` between; every call's tokens equal the eager loop's,
    and every step replays a graph, one per (variant, rows, capacity)."""
    _need_cuda()
    from repro_torch import tracing
    cfg = dataclasses.replace(configs.get_config(arch, reduced=True), dtype=torch.bfloat16)
    srv = StageServer(arch, [("a", cfg, 0.0), ("b", cfg, 0.0)], gen_tokens=6, max_ctx=24)
    rng = np.random.default_rng(21)
    plan = [("a", 1), ("a", 3), ("a", 4), ("a", 4), ("a", 3), ("b", 4), ("b", 1), ("a", 1),
            ("a", 8), ("a", 2), ("a", 5), ("a", 6), ("a", 7), ("a", 2)]
    for v, b in plan:
        srv.set_variant(v)
        prompt = rng.integers(0, cfg.vocab, (b, 16)).astype(np.int32)
        with tracing.recording() as rec:
            got, _ = srv.process(prompt)
        np.testing.assert_array_equal(got, _eager_tokens(srv, prompt))
        assert rec.counters["decode.graph"] == 6 and "decode.eager" not in rec.counters
    assert set(srv._graphs) == {(v, b, 22) for v, b in plan}


def test_a_graph_captured_under_a_recording_replays_the_same_operations():
    """Reduced jamba (MoE, whose counters run on the device while a
    recording is open): a graph captured inside a recording holds the
    device operations of one captured with none open, and serves the same
    tokens; its replays count nothing, so the MoE counters hold the
    prefill's routing."""
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    cfg = configs.get_config("jamba-v0.1-52b", reduced=True)
    prompt = np.arange(160, dtype=np.int32).reshape(4, 40)
    off_srv, on_srv = (StageServer("jamba", [("jamba", cfg, 0.0)], gen_tokens=3, max_ctx=48)
                       for _ in range(2))
    off, _ = off_srv.process(prompt)
    with tracing.recording() as rec:
        on, _ = on_srv.process(prompt)
    np.testing.assert_array_equal(on, off)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    assert rec.counters["moe.pairs"] == n_moe * 4 * cfg.moe.top_k * 40
    assert rec.counters["decode.graph"] == 3
    cuda = torch.autograd.DeviceType.CUDA
    kernels = []
    for srv in (off_srv, on_srv):
        (graph,) = srv._graphs.values()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        kernels.append([e.name() for e in prof.profiler.kineto_results.events()
                        if e.device_type() == cuda and not e.is_user_annotation()])
    assert len(kernels[0]) > 50 and kernels[0] == kernels[1]


def _graph_against_eager(cfg, b, s, steps):
    """Logits of ``steps`` graph replays and of as many eager decode steps
    from one prefill, and the K2 launches of the replays."""
    from repro_torch.serving.decode_graph import DecodeGraph
    params = M.init(cfg, seed=0)
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab, (b, s))).cuda()
    with torch.inference_mode():
        hl, caches, _ = M.prefill(params, cfg, {"tokens": toks}, capacity=s + steps)
        tok = torch.argmax(hl @ params["embed"].T, dim=-1)[:, None]
        graph = DecodeGraph(params, cfg, caches, torch.cuda.Stream(),
                            torch.cuda.graph_pool_handle())
        graph.load(tok, caches, s)
        got, want = [], []

        def replays():
            for _ in range(steps):
                graph.replay()
                got.append(graph.logits.clone())
        _, launched = _device_launches(replays)
        for i in range(steps):
            lg, caches = M.decode_step(params, cfg, caches, s + i, tok)
            want.append(lg)
            tok = torch.argmax(lg, dim=-1)[:, None]
    return torch.stack(got), torch.stack(want), launched["decode_attention"]


@pytest.mark.parametrize("arch,layers,b,s", [("yi-34b", 1, 8, 8), ("jamba-v0.1-52b", 5, 4, 64)])
def test_a_graph_replay_equals_the_eager_step_at_full_width(arch, layers, b, s):
    """yi-34b's layer (56 heads over 8 KV heads, hd 128) at the vlm cell's
    batch, and jamba's first five layers (Mamba2, MoE of 16 experts top-2,
    the attention layer) at its cell's batch, bf16 at published widths:
    each replay's logits equal the eager step's bit for bit, and a replay
    runs K2 once in each attention layer."""
    _need_cuda()
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers)
    got, want, launched = _graph_against_eager(cfg, b, s, 3)
    assert torch.equal(got, want)
    assert launched == 3 * sum(cfg.is_attn_layer(i) for i in range(layers))


def test_full_width_layer_kernel_path_matches_naive_path():
    """One yi-34b layer at full width (56 heads over 8 KV heads, hd 128),
    f32 so that the comparison sees the kernels and not bf16 rounding."""
    _need_cuda()
    cfg = dataclasses.replace(configs.get_config("yi-34b"), n_layers=1,
                              dtype=torch.float32)
    params = M.init(cfg, seed=0)
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (2, 40))).cuda()
    with torch.inference_mode():
        hk, _ = M.forward(params, cfg, {"tokens": toks}, impl="kernel")
        hn, _ = M.forward(params, cfg, {"tokens": toks}, impl="naive")
    _close(hk, hn, torch.float32)


def _ssd_inputs(seed, b, s, h, p, g, n, dtype):
    """x, B, C standard normal; dt = softplus(normal); a_neg = -linspace(1,
    16, H), the decay rates of init_mamba (a 256-row chunk then spans
    |cum| of a few thousand)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, s, h)).astype(np.float32)))
    bm = torch.from_numpy(rng.standard_normal((b, s, g, n)).astype(np.float32))
    cm = torch.from_numpy(rng.standard_normal((b, s, g, n)).astype(np.float32))
    a_neg = -torch.linspace(1.0, 16.0, h)
    return (x.to("cuda", dtype), dt.cuda(), a_neg.cuda(), bm.to("cuda", dtype),
            cm.to("cuda", dtype))


def _close_ssd(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **SSD_TOL[dtype])


# (b, s, h, p, g, n, chunk, dtype): mamba2-2.7b at full width (S 4 is what
# nlp-chain hands its third stage, S 1000 a ragged tail), the reduced
# family's widths, G > 1, and the other chunk sizes and head widths
SSD = [
    (4, 4, 80, 64, 1, 128, 256, torch.bfloat16),
    (4, 1000, 80, 64, 1, 128, 256, torch.float32),
    (4, 1024, 80, 64, 1, 128, 256, torch.bfloat16),
    (2, 100, 16, 32, 1, 16, 32, torch.float32),
    (2, 96, 8, 32, 2, 16, 32, torch.float32),
    (2, 130, 4, 16, 4, 8, 64, torch.float32),
    (1, 300, 6, 64, 3, 32, 128, torch.bfloat16),
    (2, 40, 4, 32, 1, 64, 16, torch.float32),
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,dtype", SSD)
def test_ssd_kernel_matches_plain(b, s, h, p, g, n, chunk, dtype):
    _need_cuda()
    args = _ssd_inputs(8, b, s, h, p, g, n, dtype)
    k = K3.ssd_scan.launches
    y, final = K3.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert K3.ssd_scan.launches == k + 1
    assert y.dtype == dtype and y.shape == (b, s, h, p) and final.dtype == torch.float32
    y_want, f_want = K3.ssd_scan_plain(*args, chunk)
    _close_ssd(y, y_want, dtype)
    _close_ssd(final, f_want, torch.float32)


def _ssd_edge_cases():
    """bf16 cases of the tensor-core passes: S in {1, 15, 255, 257, 1000}
    at every chunk size, cycling through every (P, N) the wrapper accepts
    and G in {1, 2}."""
    pn = [(p, n) for p in K3.HEAD_DIMS for n in K3.STATE_DIMS]
    cases = []
    for chunk in K3.CHUNKS:
        for s in (1, 15, 255, 257, 1000):
            p, n = pn[len(cases) % len(pn)]
            cases.append((s, chunk, p, n, 1 + len(cases) % 2))
    return cases


@pytest.mark.parametrize("s,chunk,p,n,g", _ssd_edge_cases())
def test_ssd_bf16_edges_match_plain(s, chunk, p, n, g):
    _need_cuda()
    args = _ssd_inputs(13, 2, s, 4, p, g, n, torch.bfloat16)
    y, final = K3.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    y_want, f_want = K3.ssd_scan_plain(*args, chunk)
    _close_ssd(y, y_want, torch.bfloat16)
    _close_ssd(final, f_want, torch.float32)


@pytest.mark.parametrize("b,s,g", [(1, 1024, 1), (2, 1000, 1), (2, 600, 2)])
def test_ssd_bf16_y_rounds_like_the_plain_version(b, s, g):
    """At mamba2-2.7b's widths the bf16 kernel's y rounds to another bf16
    value than the f32 plain version's at no more than 2e-4 of the outputs:
    each f32 operand enters as three bf16 terms (5e-5 to 8e-5 on an H100;
    two terms, which still hold the 2e-2 tolerance, give 6e-4)."""
    _need_cuda()
    args = _ssd_inputs(16, b, s, 80, 64, g, 128, torch.bfloat16)
    y, _ = K3.ssd_scan(*args, chunk=256)
    y_want, _ = K3.ssd_scan_plain(*args, 256)
    assert (y != y_want).float().mean().item() <= 2e-4


@pytest.mark.parametrize("chunk", [32, 256])
def test_ssd_kernel_init_state_continuation(chunk):
    """Two halves with the first half's final state carried == one pass."""
    _need_cuda()
    x, dt, a_neg, bm, cm = _ssd_inputs(9, 2, 600, 16, 64, 1, 128, torch.float32)
    y, final = K3.ssd_scan(x, dt, a_neg, bm, cm, chunk=chunk)
    m = 333
    y1, f1 = K3.ssd_scan(x[:, :m].contiguous(), dt[:, :m].contiguous(), a_neg,
                         bm[:, :m].contiguous(), cm[:, :m].contiguous(), chunk=chunk)
    y2, f2 = K3.ssd_scan(x[:, m:].contiguous(), dt[:, m:].contiguous(), a_neg,
                         bm[:, m:].contiguous(), cm[:, m:].contiguous(), chunk=chunk,
                         init_state=f1)
    _close_ssd(torch.cat([y1, y2], dim=1), y, torch.float32)
    _close_ssd(f2, final, torch.float32)
    y_want, f_want = K3.ssd_scan_plain(x[:, m:], dt[:, m:], a_neg, bm[:, m:], cm[:, m:],
                                       chunk, init_state=f1)
    _close_ssd(y2, y_want, torch.float32)
    _close_ssd(f2, f_want, torch.float32)


def test_ssd_bf16_state_carried_across_halves():
    """bf16 at mamba2-2.7b's widths: S 1000 in two halves of 500 (neither a
    whole number of chunks), the first half's f32 state carried."""
    _need_cuda()
    x, dt, a_neg, bm, cm = _ssd_inputs(14, 2, 1000, 80, 64, 1, 128, torch.bfloat16)
    y, final = K3.ssd_scan(x, dt, a_neg, bm, cm, chunk=256)
    halves = [[t[:, sl].contiguous() for t in (x, dt)] + [a_neg]
              + [t[:, sl].contiguous() for t in (bm, cm)]
              for sl in (slice(0, 500), slice(500, None))]
    y1, f1 = K3.ssd_scan(*halves[0], chunk=256)
    y2, f2 = K3.ssd_scan(*halves[1], chunk=256, init_state=f1)
    torch.cuda.synchronize()
    _close_ssd(torch.cat([y1, y2], dim=1), y, torch.bfloat16)
    _close_ssd(f2, final, torch.float32)
    y_want, f_want = K3.ssd_scan_plain(*halves[1], 256, init_state=f1)
    _close_ssd(y2, y_want, torch.bfloat16)
    _close_ssd(f2, f_want, torch.float32)


def test_ssd_wrapper_refuses_before_launching():
    _need_cuda()
    x, dt, a_neg, bm, cm = _ssd_inputs(10, 1, 8, 4, 48, 1, 16, torch.float32)
    k = K3.ssd_scan.launches
    with pytest.raises(ValueError):
        K3.ssd_scan(x, dt, a_neg, bm, cm, chunk=32)
    assert K3.ssd_scan.launches == k


@pytest.mark.parametrize("s", [70, 64])
def test_mamba_kernel_path_matches_naive_path(s):
    """Reduced mamba2: prefill (ragged and whole chunks) and decode, f32."""
    _need_cuda()
    cfg = configs.get_config("mamba2-2.7b", reduced=True)
    params = M.init(cfg, seed=0)
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab, (2, s + 4))).cuda()
    out = {}
    with torch.inference_mode():
        for impl in ("kernel", "naive"):
            hl, caches, _ = M.prefill(params, cfg, {"tokens": toks[:, :s]}, impl=impl)
            lgs = [hl @ params["embed"].T]
            for t in range(s, s + 4):
                lg, caches = M.decode_step(params, cfg, caches, t, toks[:, t:t + 1], impl=impl)
                lgs.append(lg)
            out[impl] = torch.stack(lgs)
    np.testing.assert_allclose(out["kernel"].cpu().numpy(), out["naive"].cpu().numpy(),
                               **MAMBA_TOL)


def test_engine_runs_the_ssd_kernel():
    _need_cuda()
    fam = configs.get_variant_family("mamba2-2.7b")
    srv = StageServer("mamba2-2.7b", fam, gen_tokens=3)
    for name, cfg, _ in fam:
        srv.set_variant(name)
        srv.process(np.zeros((2, 40), np.int32))
        k = K3.ssd_scan.launches
        out, lat = srv.process(np.arange(80, dtype=np.int32).reshape(2, 40))
        assert K3.ssd_scan.launches - k == cfg.n_layers
        assert out.shape == (2, 3) and lat > 0


def test_full_width_mamba_layer_kernel_path_matches_naive_path():
    """One mamba2-2.7b layer at full width (80 heads of 64, d_state 128,
    chunk 256), f32, a ragged 300-token prompt."""
    _need_cuda()
    cfg = dataclasses.replace(configs.get_config("mamba2-2.7b"), n_layers=1,
                              dtype=torch.float32)
    params = M.init(cfg, seed=0)
    toks = torch.from_numpy(np.random.default_rng(12).integers(0, cfg.vocab, (2, 300))).cuda()
    with torch.inference_mode():
        hk, _ = M.forward(params, cfg, {"tokens": toks}, impl="kernel")
        hn, _ = M.forward(params, cfg, {"tokens": toks}, impl="naive")
    np.testing.assert_allclose(hk.cpu().numpy(), hn.cpu().numpy(), **MAMBA_TOL)


def test_moe_einsum_and_gather_dispatch_agree_at_full_width():
    """One qwen2-moe layer at its published widths (60 experts top-4 of
    d_ff 1408, 4 shared experts, d 2048) in bf16 on the card, 1024 tokens
    (capacity 86): both dispatch modes route alike and agree within the
    bf16 tolerance; the router stays f32."""
    _need_cuda()
    mcfg = configs.get_config("qwen2-moe-a2.7b").moe
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = MO.init_moe(gen, 2048, mcfg, True, torch.bfloat16)
    assert params["router"].dtype == torch.float32
    x = _randn(13, (4, 256, 2048), torch.bfloat16)
    with torch.inference_mode():
        y1, a1 = MO.moe_apply(params, x, mcfg, impl="einsum")
        y2, a2 = MO.moe_apply(params, x, mcfg, impl="gather")
    assert y1.dtype == torch.bfloat16 and torch.isfinite(y1.float()).all()
    _close(y1, y2, torch.bfloat16)
    _close(a1, a2, torch.float32)


def _broadcast_expert_ffn(params, xd):
    """The experts as one broadcast matmul over the routing groups, the
    form ``moe._expert_ffn`` had before it took one batched product an
    expert over every group's rows."""
    h = xd @ params["w_in"]
    if "w_gate" in params:
        h = torch.nn.functional.silu(xd @ params["w_gate"]) * h
    else:
        h = torch.nn.functional.gelu(h, approximate="tanh")
    return h @ params["w_out"]


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("tokens", [4, 32, 1024, 8192])
def test_moe_layer_equals_the_broadcast_expert_products(arch, tokens, monkeypatch):
    """One MoE layer at its published widths in bf16 (einsum dispatch),
    the experts' batched products against the broadcast matmul: up to one
    routing group (GROUP_SIZE tokens, every batch the engines serve) the
    products have the same shapes and the outputs are equal bit for bit;
    over two groups the products have twice the rows and the outputs agree
    within the bf16 tolerance."""
    _need_cuda()
    cfg = configs.get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = MO.init_moe(gen, cfg.d_model, cfg.moe, cfg.mlp_gated, torch.bfloat16)
    x = _randn(17, (4, tokens // 4, cfg.d_model), torch.bfloat16)
    with torch.inference_mode():
        y, aux = MO.moe_apply(params, x, cfg.moe)
        monkeypatch.setattr(MO, "_expert_ffn", _broadcast_expert_ffn)
        y0, aux0 = MO.moe_apply(params, x, cfg.moe)
    diff = float((y.float() - y0.float()).abs().max())
    print(f"{arch} T={tokens}: {tokens // min(tokens, MO.GROUP_SIZE)} routing groups, "
          f"max abs diff {diff:.4e}")
    assert torch.equal(aux, aux0) and torch.isfinite(y.float()).all()
    if tokens <= MO.GROUP_SIZE:
        assert torch.equal(y, y0)
    else:
        _close(y, y0, torch.bfloat16)
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# training, the LSTM predictor and solve_enum on the card
# ---------------------------------------------------------------------------
def _train_step_on(device, arch="starcoder2-3b"):
    """One AdamW step of reduced f32 ``arch`` from the seed-0 params of the
    CPU on ``device``: (loss, grad norm, grads and params after, on the CPU)."""
    from repro_torch.training import data, optim
    from repro_torch.training import train as T
    cfg = configs.get_config(arch, reduced=True)
    params = optim.tree_map(lambda p: p.to(device), M.init(cfg, seed=0, device="cpu"))
    batch = data.to_device(data.SyntheticStream(cfg, data.DataConfig(seq_len=32, batch_size=2))
                           .batch(0), device)
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = T.loss_fn(params, cfg, batch, impl="naive")
    grads = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
    for p in leaves:
        p.requires_grad_(False)
    step = T.make_train_step(cfg, optim.AdamWConfig(total_steps=10), impl="naive")
    params, _, m = step(params, optim.init_state(params), batch)
    return (float(loss.detach()), float(m["grad_norm"]), grads,
            [p.cpu() for p in optim.tree_leaves(params)])


@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen2-moe-a2.7b", "mamba2-2.7b"])
def test_train_step_on_the_card_matches_the_cpu(arch):
    """Loss and gradients within 2e-4 (each leaf against its largest
    gradient); the step's params are not compared element by element, since
    AdamW's first step moves each by lr * sign(g)."""
    _need_cuda()
    loss_c, norm_c, grads_c, _ = _train_step_on("cpu", arch)
    loss_g, norm_g, grads_g, params_g = _train_step_on("cuda", arch)
    assert abs(loss_g - loss_c) < 2e-4
    assert norm_g == pytest.approx(norm_c, rel=2e-4)
    for g, c in zip(grads_g, grads_c):
        assert float((g - c).abs().max()) <= 2e-4 * max(float(c.abs().max()), 1e-30)
    assert all(torch.isfinite(p).all() for p in params_g)


def test_kernels_refuse_autograd_on_the_card():
    _need_cuda()
    from repro_torch.kernels import ops
    from repro_torch.kernels import _build

    def t(*shape, dtype=torch.float32):
        return _randn(sum(shape), shape, dtype).requires_grad_(True)
    calls = {"flash_attention": lambda: ops.flash_attention(t(1, 8, 2, 32), t(1, 8, 2, 32),
                                                            t(1, 8, 2, 32)),
             "decode_attention": lambda: ops.decode_attention(
                 t(1, 2, 32), t(1, 8, 2, 32), t(1, 8, 2, 32),
                 torch.tensor([5], dtype=torch.int32, device="cuda")),
             "ssd_scan": lambda: ops.ssd_scan(t(1, 16, 2, 16), torch.rand(1, 16, 2, device="cuda"),
                                              -torch.rand(2, device="cuda"), t(1, 16, 1, 8),
                                              t(1, 16, 1, 8), chunk=16)}
    counts = (K1.flash_attention.launches, K2.decode_attention.launches, K3.ssd_scan.launches)
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="impl='naive' or impl='chunked'"):
            call()
    assert (K1.flash_attention.launches, K2.decode_attention.launches,
            K3.ssd_scan.launches) == counts
    assert _build.refuse_autograd("x", torch.zeros(1, device="cuda")) is None


def test_lstm_on_the_card_matches_the_cpu():
    _need_cuda()
    from repro_torch.core import predictor as PR
    params = PR.init_lstm(torch.Generator().manual_seed(0))
    x = np.random.default_rng(3).standard_normal((64, PR.HISTORY)).astype(np.float32)
    want = PR.lstm_apply(params, torch.from_numpy(x))
    got = PR.lstm_apply({k: v.cuda() for k, v in params.items()}, torch.from_numpy(x).cuda())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", range(6))
def test_solve_enum_on_the_card_matches_brute(seed):
    _need_cuda()
    from repro_torch.core import optimizer as OPT
    from repro_torch.core import pipeline as P
    rng = np.random.default_rng(seed)
    stages = []
    for s in range(int(rng.integers(1, 4))):
        variants = []
        for v in range(int(rng.integers(1, 4))):
            l1 = float(rng.uniform(0.01, 0.4))
            variants.append(P.ModelVariant(name=f"s{s}v{v}", accuracy=float(rng.uniform(30, 95)),
                                           base_alloc=int(rng.choice([1, 2, 4, 8])),
                                           latency_coeffs=(l1 * 0.001, l1 * 0.6, l1 * 0.4)))
        sla = float(5.0 * np.mean([v.latency(1) for v in variants]))
        stages.append(P.StageModel(f"stage{s}", tuple(variants), sla, batch_choices=(1, 2, 4, 8)))
    pipe = P.PipelineModel("rand", tuple(stages))
    obj = OPT.Objective(alpha=2.0, beta=0.7, delta=1e-5, metric="pas")
    for lam in (0.5, 9.0, 55.0):
        e, b = OPT.solve_enum(pipe, lam, obj), OPT.solve_brute(pipe, lam, obj)
        assert e.feasible == b.feasible
        if b.feasible:
            assert e.objective == pytest.approx(b.objective, rel=1e-9)
            assert OPT.solve_enum(pipe, lam, obj, device="cpu").config == e.config


# The caching allocator rounds a block up to 512 bytes, keeps a large block
# whole where splitting it would leave at most 1 MiB, and rounds segments up
# to 2 MiB: a tensor may hold up to 2 MiB more than its bytes.
ALLOC_SLACK = 2 << 20


@pytest.mark.parametrize("arch", ["yi-34b", "jamba-v0.1-52b"])
def test_dryrun_probe_on_the_card_allocates_what_it_counts(arch):
    """A reduced decode case of the dry run built on the card: its tensors
    hold the dry run's per-device argument bytes on a 1x1 mesh (less the
    reference's int32 position, a Python int here), the allocator at most
    ALLOC_SLACK a tensor more; the step runs K2 once an attention layer and
    its logits are those of the naive path on the same arguments."""
    _need_cuda()
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import stack as ST
    from repro_torch.training import optim
    cfg = configs.get_config(arch, reduced=True)
    shape, mesh = InputShape("small_decode", 256, 4, "decode"), MeshShape(("data", "model"), (1, 1))
    meta = DR.build_case(cfg, shape, mesh)
    count = DR.sharded_bytes(meta.arg_shapes, meta.arg_specs, mesh)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    case = DR.build_case(cfg, shape, mesh, impl="kernel", device="cuda")
    alloc = torch.cuda.memory_allocated() - base
    leaves = optim.tree_leaves(case.args)
    storage = sum(t.untyped_storage().nbytes() for t in leaves)
    assert storage == count - 4
    assert 0 <= alloc - storage <= ALLOC_SLACK * len(leaves)
    before = K2.decode_attention.launches
    with torch.no_grad():
        got, _ = case.fn(*case.args)
        torch.cuda.synchronize()
        n_attn = sum(s.is_attn for s in ST.layer_specs(cfg))
        assert K2.decode_attention.launches - before == n_attn
        params, caches, tokens = case.args
        want, _ = M.decode_step(params, cfg, caches, shape.seq_len - 1, tokens, impl="naive")
    _close(got, want, torch.float32)


def test_adaptability_on_the_card_prints_the_cpu_table():
    _need_cuda()
    import contextlib
    import io

    from repro_torch.examples import adaptability

    def printed(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            adaptability.main(argv)
        return buf.getvalue().splitlines()
    card, cpu = printed([]), printed(["--device", "cpu"])
    assert len(card) == 16 and card == cpu
