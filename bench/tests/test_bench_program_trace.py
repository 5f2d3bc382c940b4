"""bench/program_trace.py on hand-made profiler events: each device
operation's time goes to the program span open at its launch, whenever the
device runs it; an operation with no launch is not joined; the numbers read
from the device are None under MIN_COVERAGE."""
import types

import pytest
import torch

from bench import program_trace as PT

# name, start, end, parent
SPANS = [("batch", 0, 1000, -1), ("stage", 0, 1000, 0),
         ("decode", 100, 400, 1), ("attn", 110, 200, 2), ("moe", 200, 390, 2),
         ("moe.route", 200, 220, 4), ("moe.dispatch", 220, 260, 4), ("count", 230, 240, 6),
         ("moe.experts", 260, 340, 4), ("moe.combine", 340, 380, 4),
         ("decode", 400, 700, 1), ("mlp", 410, 690, 10), ("sync", 900, 1000, 1)]
HARNESS = [(0, 1000, "window"), (0, 1000, "batch"), (0, 1000, "stage0.yi-34b")]
# name, launch (None: no runtime call recorded), device start, duration
OPS = [("a", 150, 450, 20),     # launched in decode 0's attn, run during decode 1
       ("b", 235, 470, 5),      # a device counter's reduction
       ("c", 250, 475, 10), ("d", 300, 485, 30), ("e", 350, 515, 10),
       ("f", 500, 600, 40),     # decode 1's mlp
       ("g", 50, 60, 40)]       # in the stage, outside any decode


class Event:
    def __init__(self, device, corr, start, dur=0, name="cudaLaunchKernel"):
        self._d, self._c, self._s, self._n, self._name = device, corr, start, dur, name

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._c

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._n

    def name(self):
        return self._name


def _events(unjoined_ns):
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    ev = []
    for i, (name, launch, start, dur) in enumerate(OPS + [("h", None, 800, unjoined_ns)]):
        ev.append(Event(cuda, i + 1, start, dur, name))
        if launch is not None:
            ev.append(Event(cpu, i + 1, launch))
    return ev[::-1]


def _program():
    return [types.SimpleNamespace(name=n, start_ns=a, end_ns=b, parent=p) for n, a, b, p in SPANS]


def test_device_time_goes_to_the_span_open_at_launch():
    ops = PT.device_ops(_events(5))
    prog = PT.Nest.of_program(_program())
    where = PT.join(ops, prog)
    assert dict(zip(ops["name"], where.tolist())) == {
        "a": 3, "b": 7, "c": 6, "d": 8, "e": 9, "f": 11, "g": 1, "h": -1}
    got = PT.read_spans_window(ops, types.SimpleNamespace(spans=_program(), counters={}),
                               HARNESS)["device_by_span"]
    stage = "batch/stage0.yi-34b"
    want = [[stage, 40], [stage + "/decode/mlp", 40], [stage + "/decode/moe/moe.experts", 30],
            [stage + "/decode/attn", 20], [stage + "/decode/moe/moe.dispatch", 10],
            [stage + "/decode/moe/moe.combine", 10],
            [stage + "/decode/moe/moe.dispatch/count", 5], ["unjoined", 5]]
    assert [k for k, _ in got] == [k for k, _ in want]
    assert [v for _, v in got] == pytest.approx([v * 1e-9 for _, v in want])


@pytest.mark.parametrize("unjoined_ns", [5, 100])
def test_the_four_numbers_and_the_coverage(unjoined_ns):
    ops = PT.device_ops(_events(unjoined_ns))
    prog = PT.Nest.of_program(_program())
    got = PT.program_numbers(ops, prog, PT.join(ops, prog))
    assert got["decode_host_ms"] == pytest.approx(300e-6)
    assert got["join_coverage"] == pytest.approx(155 / (155 + unjoined_ns))
    if unjoined_ns == 5:
        assert got["decode_device_ms"] == pytest.approx(110e-6 / 2)
        assert got["kernels_per_decode"] == 2.5
        assert got["moe_dispatch_share"] == pytest.approx(20 / 50)
    else:
        assert got["join_coverage"] < PT.MIN_COVERAGE
        assert [got[k] for k in ("decode_device_ms", "kernels_per_decode",
                                 "moe_dispatch_share")] == [None] * 3


def test_idle_gaps_are_labelled_by_the_spans_open_at_their_middle():
    ops = PT.device_ops(_events(5))
    mids, gaps = PT.idle_gaps(ops, 0, 1000)
    assert list(zip(mids.tolist(), gaps.tolist())) == [
        (30, 60), (275, 350), (562, 75), (720, 160), (902, 195)]
    labels = PT.seconds_by_label(mids, gaps, PT.Nest.of_harness(HARNESS),
                                 PT.Nest.of_program(_program()))
    stage = "batch/stage0.yi-34b"
    assert dict(labels) == pytest.approx({
        stage: 220e-9, stage + "/decode/moe/moe.experts": 350e-9,
        stage + "/decode/mlp": 75e-9, stage + "/sync": 195e-9})


def test_harness_spans_nest_by_time():
    nest = PT.Nest.of_harness([(10, 20, "stage0"), (0, 100, "window"), (0, 50, "batch"),
                               (60, 70, "wait")])
    assert nest.name == ["window", "batch", "stage0", "wait"]
    assert nest.parent.tolist() == [-1, 0, 1, 0]
    assert nest.at([0, 15, 20, 65, 99, 100]).tolist() == [1, 2, 1, 3, 0, -1]
