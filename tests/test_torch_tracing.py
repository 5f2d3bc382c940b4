"""repro_torch.tracing and the spans and counters of the serving path, on
reduced configurations on the CPU: the recorder changes no output, records
nothing unless a recording is open, and a stage's call gives the spans the
layers run, nested, in order, with the MoE counters equal to a hand count."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs, tracing
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as MO
from repro_torch.serving.engine import PipelineEngine, StageServer

ARCHS = ("yi-34b", "jamba-v0.1-52b")
PROMPT = np.arange(2 * 12, dtype=np.int32).reshape(2, 12) * 7


def _server(arch, gen=3):
    cfg = configs.get_config(arch, reduced=True)
    return StageServer(arch, [(arch, cfg, 0.0)], gen_tokens=gen, max_ctx=16, device="cpu")


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s.parent == i]


def _names(spans, idx):
    return [spans[j].name for j in idx]


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """One stage's call with the recorder off, then on."""
    srv = _server(request.param)
    off, _ = srv.process(PROMPT)
    with tracing.recording() as rec:
        on, _ = srv.process(PROMPT)
    return srv, off, on, rec


def test_tokens_are_identical_with_the_recorder_on_and_off(served):
    _, off, on, rec = served
    assert rec.spans
    np.testing.assert_array_equal(on, off)


def test_a_disabled_span_is_the_one_shared_object():
    assert tracing.span("attn") is tracing.span("batch") is tracing._OFF
    with tracing.span("decode") as s:
        assert s is tracing._OFF
    tracing.count("moe.pairs", 5)
    tracing.count_device("moe.dropped", torch.arange(4), at_least=2)
    _server("yi-34b", gen=2).process(PROMPT)
    with tracing.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


@pytest.mark.parametrize("gen", [1, 4])
def test_a_call_gives_one_stage_one_prefill_n_decodes_and_one_sync(gen):
    srv = _server("yi-34b", gen)
    with tracing.recording() as rec:
        srv.process(PROMPT)
    top = [j for j, s in enumerate(rec.spans) if s.parent == -1]
    assert _names(rec.spans, top) == ["stage"]
    kids = _children(rec.spans, 0)
    assert _names(rec.spans, kids) == ["prefill"] + ["decode"] * gen + ["sync"]
    # yi has no MoE layer; on the CPU every decode step runs eagerly
    assert rec.counters == {"decode.eager": gen}


def test_a_batch_span_holds_each_stage():
    engine = PipelineEngine([_server("yi-34b", 2), _server("yi-34b", 3)])
    with tracing.recording() as rec:
        engine.serve(PROMPT)
    assert rec.spans[0].name == "batch"
    kids = _children(rec.spans, 0)
    assert _names(rec.spans, kids) == ["stage", "stage"]
    assert [_names(rec.spans, _children(rec.spans, j)) for j in kids] == [
        ["prefill"] + ["decode"] * n + ["sync"] for n in (2, 3)]


def test_each_decode_holds_one_block_span_per_layer_of_its_kind(served):
    srv, _, _, rec = served
    cfg = srv.config
    want = []
    for i in range(cfg.n_layers):
        want.append("attn" if cfg.is_attn_layer(i) else "mamba")
        if cfg.is_moe_layer(i):
            want.append("moe")
        elif cfg.d_ff > 0:
            want.append("mlp")
    if cfg.arch_id == "jamba-v0.1-52b":
        assert set(want) == {"attn", "mamba", "moe", "mlp"}
    decodes = [j for j, s in enumerate(rec.spans) if s.name == "decode"]
    assert len(decodes) == srv.gen_tokens
    for d in decodes:
        kids = _children(rec.spans, d)
        assert _names(rec.spans, kids[:-1]) == want
        assert rec.spans[kids[-1]].name == "final"


def test_the_served_moe_spans_hold_route_dispatch_experts_combine(served):
    srv, _, _, rec = served
    moes = [j for j, s in enumerate(rec.spans) if s.name == "moe"]
    n_moe = sum(srv.config.is_moe_layer(i) for i in range(srv.config.n_layers))
    assert len(moes) == n_moe * (1 + srv.gen_tokens)
    for m in moes:
        assert _names(rec.spans, _children(rec.spans, m)) == [
            "moe.route", "moe.dispatch", "moe.experts", "moe.combine"]


@pytest.mark.parametrize("impl,groups", [("einsum", 1), ("gather", 1), ("gather", 2)])
def test_moe_phases_in_order_in_both_dispatch_modes(impl, groups):
    params, x, mcfg = _moe_layer()
    with tracing.recording() as rec:
        with tracing.span("moe"):
            MO.moe_apply(params, x, mcfg, impl=impl, group_size=x.shape[1] // groups)
    assert _names(rec.spans, _children(rec.spans, 0)) == [
        "moe.route", "moe.dispatch", "moe.experts", "moe.combine"] * groups


def test_parents_nest_and_times_are_monotone(served):
    _, _, _, rec = served
    spans = rec.spans
    assert all(s.start_ns <= s.end_ns for s in spans)
    assert all(a.start_ns <= b.start_ns for a, b in zip(spans, spans[1:]))
    for i, s in enumerate(spans):
        if s.parent >= 0:
            p = spans[s.parent]
            assert s.parent < i and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        kids = [spans[j] for j in _children(spans, i)]
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))


def _moe_layer():
    """A layer of 4 experts, top-2, over 16 tokens that all route to
    experts 0 and 1: each gets 16 pairs against a capacity of 9."""
    mcfg = MoEConfig(n_experts=4, top_k=2, d_ff_expert=8, capacity_factor=1.0)
    gen = torch.Generator().manual_seed(0)
    params = MO.init_moe(gen, 16, mcfg, True, torch.float32)
    params["router"] = torch.tensor([[1.0, 0.5, -1.0, -1.0]]).repeat(16, 1)
    x = torch.rand((1, 16, 16), generator=gen) + 0.1
    return params, x, mcfg


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_moe_counters_equal_a_hand_count(impl):
    params, x, mcfg = _moe_layer()
    cap = MO._capacity(16, mcfg)
    _, top_i, _ = MO._route(params, x.reshape(16, 16), mcfg)
    pos = MO._positions_in_expert(top_i, mcfg, cap)
    assert cap == 9 and set(top_i.flatten().tolist()) == {0, 1}
    with tracing.recording() as rec:
        MO.moe_apply(params, x, mcfg, impl=impl)
        MO.moe_apply(params, x, dataclasses.replace(mcfg, capacity_factor=4.0), impl=impl)
    assert rec.counters == {"moe.pairs": 2 * pos.numel(), "moe.dropped": int((pos >= cap).sum())}
    assert rec.counters["moe.dropped"] == 14
    counts = [s for s in rec.spans if s.name == "count"]
    assert len(counts) == 2 and all(rec.spans[s.parent].name == "moe.dispatch" for s in counts)


class _Ops(TorchDispatchMode):
    """Every aten operation run in the block, with the name of the innermost
    span open when it ran (None where none is)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        rec = tracing._active
        where = None if rec is None or rec._open < 0 else rec.spans[rec._open].name
        self.ops.append((str(func), where))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_the_counters_run_nothing_outside_their_count_span(impl):
    """With no recording open the MoE layer runs no operation for its
    counters; with one open, all the counters' work (the comparison with
    the capacity included) runs inside ``count`` spans, and the layer's
    other operations are those it runs with the recorder off."""
    params, x, mcfg = _moe_layer()
    with _Ops() as off:
        MO.moe_apply(params, x, mcfg, impl=impl)
    with tracing.recording():
        with _Ops() as on:
            MO.moe_apply(params, x, mcfg, impl=impl)
    counted = [f for f, where in on.ops if where == "count"]
    assert [f for f, _ in off.ops] == [f for f, where in on.ops if where != "count"]
    assert "aten.ge.Scalar" in counted
    assert not any(f.startswith("aten.ge.") for f, _ in off.ops)


def test_a_recording_closes_spans_on_errors_and_does_not_nest():
    with tracing.recording() as rec:
        with pytest.raises(RuntimeError, match="already open"):
            with tracing.recording():
                pass
        with pytest.raises(KeyError):
            with tracing.span("stage"):
                with tracing.span("prefill"):
                    raise KeyError("x")
        with tracing.span("sync"):
            pass
    assert [(s.name, s.parent) for s in rec.spans] == [("stage", -1), ("prefill", 0),
                                                        ("sync", -1)]
    assert all(s.end_ns >= s.start_ns > 0 for s in rec.spans)
    assert tracing.span("x") is tracing._OFF
