"""The decode step's position on the device, and the engine's choice of
path, on the CPU.

``model.decode_step`` takes ``cache_len`` as an int or as a 0-d integer
tensor (what a CUDA graph of the step reads, since a graph replays at any
length): both give the same logits and caches, bit for bit, over several
steps, in dense GQA (yi), Mamba2 with MoE (jamba), sliding-window ring
caches run past their wrap (gemma3) and cross-attention (whisper), through
the kernels' wrappers and the naive path.  On the CPU a ``StageServer``
runs every step eagerly and counts each as ``decode.eager``.  The graphs
themselves run on the card (``tests/test_torch_gpu.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch import configs, tracing
from repro_torch.models import model as M
from repro_torch.serving.engine import StageServer

# (arch, prompt, capacity, steps): gemma3's window is 64, so its local
# layers' rings wrap at position 64, inside the steps
CASES = [("yi-34b", 12, 20, 6), ("jamba-v0.1-52b", 12, 20, 6),
         ("gemma3-27b", 60, 72, 10), ("whisper-medium", 12, 20, 6)]


def _decode_both(arch, s, cap, steps, impl):
    cfg = configs.get_config(arch, reduced=True)
    params = M.init(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, s + steps)))
    batch = {"tokens": toks[:, :s]}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    out = {}
    with torch.inference_mode():
        _, caches, _ = M.prefill(params, cfg, batch, impl=impl, capacity=cap)
        for kind in ("int", "tensor"):
            c = [{k: t.clone() for k, t in layer.items()} for layer in caches]
            clen = s if kind == "int" else torch.tensor(s)
            lgs = []
            for t in range(s, s + steps):
                lg, c = M.decode_step(params, cfg, c, clen, toks[:, t:t + 1], impl=impl)
                lgs.append(lg)
                if kind == "int":
                    clen += 1
                else:
                    clen.add_(1)
            out[kind] = torch.stack(lgs), c
    return out


@pytest.mark.parametrize("impl", ["kernel", "naive"])
@pytest.mark.parametrize("arch,s,cap,steps", CASES)
def test_decode_step_at_a_device_length_equals_the_int_length(arch, s, cap, steps, impl):
    out = _decode_both(arch, s, cap, steps, impl)
    (li, ci), (lt, ct) = out["int"], out["tensor"]
    assert torch.equal(li, lt)
    assert [sorted(c) for c in ci] == [sorted(c) for c in ct]
    for a, b in zip(ci, ct):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("arch", ["yi-34b", "jamba-v0.1-52b"])
def test_the_cpu_server_decodes_eagerly(arch):
    cfg = configs.get_config(arch, reduced=True)
    srv = StageServer(arch, [(arch, cfg, 0.0)], gen_tokens=3, max_ctx=16, device="cpu")
    prompt = np.arange(24, dtype=np.int32).reshape(2, 12)
    with tracing.recording() as rec:
        srv.process(prompt)
    assert rec.counters["decode.eager"] == srv.gen_tokens
    assert "decode.graph" not in rec.counters
    assert srv._graphs == {}


def test_a_paused_block_records_nothing():
    with tracing.recording() as rec:
        with tracing.span("stage"):
            with tracing.paused():
                with tracing.span("decode"):
                    tracing.count("moe.pairs", 4)
                    tracing.count_device("moe.dropped", torch.arange(4), at_least=2)
            tracing.count("moe.pairs", 1)
            tracing.count_device("moe.dropped", torch.arange(4), at_least=3)
    assert [sp.name for sp in rec.spans] == ["stage", "count"]
    assert rec.counters == {"moe.pairs": 1, "moe.dropped": 1}
    with tracing.paused():
        tracing.count("moe.pairs", 2)
    assert tracing._active is None
