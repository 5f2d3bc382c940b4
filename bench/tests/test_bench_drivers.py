"""The open- and closed-loop drivers against a stub engine with a fixed
service time on a fake clock."""
import math
import types

import numpy as np

from bench import harness
from bench.traffic import arrivals, drivers
from repro_torch.serving.batching import CentralQueue


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


def stub(clock, service, fail_batches=(), calls=None):
    n = [0]

    def serve(tokens):
        n[0] += 1
        if calls is not None:
            calls.append(tokens.shape[0])
        clock.t += service(n[0])
        if n[0] in fail_batches:
            raise RuntimeError("stub failure")
        return tokens[:, :2], [service(n[0])]
    return serve


def prompt(i):
    return np.full(4, i, np.int32)


def _metric(name, run, **traffic):
    ctx = types.SimpleNamespace(run=run, cell=types.SimpleNamespace(traffic=traffic))
    return harness.load_metric(name).read(ctx)


def test_latency_is_stamped_from_the_due_time_so_a_stall_delays_later_requests():
    clock = Clock()
    # batch 1 stalls for 5 s, every other batch takes 0.1 s
    serve = stub(clock, lambda n: 5.0 if n == 1 else 0.1)
    offs = np.arange(10) * 0.5
    run = drivers.run_open(CentralQueue(batch_size=1, max_wait=0.0), serve, prompt, offs,
                           clock, clock.sleep)
    lat = [r.latency for r in run.recs]
    assert lat[0] == 5.0
    # request 1 was due 0.5 s in and waited for the stalled batch: 4.5 s + its own 0.1 s
    assert math.isclose(lat[1], 4.6)
    assert all(l > 0.1 for l in lat[1:8])
    assert all(r.pushed >= r.due for r in run.recs)
    assert max(r.pushed - r.due for r in run.recs) > 4.0      # the generator ran late
    assert all(r.popped >= r.due for r in run.recs)


def test_failed_requests_count_as_misses():
    clock = Clock()
    serve = stub(clock, lambda n: 0.1, fail_batches={2})
    # one request a batch: the queue's max_wait forms each before the next is due
    run = drivers.run_open(CentralQueue(batch_size=2, max_wait=0.05), serve, prompt,
                           np.arange(8) * 0.3, clock, clock.sleep)
    failed = [r for r in run.recs if r.failed]
    assert [r.rid for r in failed] == [1] and math.isinf(failed[0].latency)
    assert _metric("sla_attained", run, sla_s=10.0) == 7 / 8
    assert math.isinf(_metric("latency_p95_s", run))
    assert _metric("latency_p50_s", run) < 1.0


def test_closed_loop_keeps_every_client_in_flight():
    clock = Clock()
    sizes = []
    serve = stub(clock, lambda n: 0.5, calls=sizes)
    q = CentralQueue(batch_size=8, max_wait=0.25)
    run = drivers.run_closed(q, serve, prompt, 16, 10.0, clock, clock.sleep)
    assert set(sizes) == {8}
    # 16 in flight at every batch: 8 served, 8 queued, and 8 more sent back
    assert len(q) == 16
    assert len(run.recs) == 8 * len(run.batches)
    assert math.isclose(_metric("completed_rps", run), 16.0)


def test_poisson_fixed_offers_the_same_gaps_in_a_seeded_order():
    a = arrivals.poisson_fixed(5.0, 40.0, 1)
    b = arrivals.poisson_fixed(5.0, 40.0, 2 ** 31 + 7)
    assert len(a) == len(b) == 200 and a[0] == b[0] == 0.0
    assert np.allclose(np.sort(np.diff(a)), np.sort(np.diff(b)))
    assert not np.allclose(np.diff(a), np.diff(b))
    assert a[-1] < 40.0
    assert np.array_equal(a, arrivals.poisson_fixed(5.0, 40.0, 1))



def test_sets_spreads_are_quartiles_over_the_median():
    from bench import sets
    a = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    b = [2.0, 2.0, 2.0, 2.0, 2.0, 20.0]
    assert math.isclose(sets.spread(a), (5.25 - 1.75) / 3.5)
    assert sets.without_farthest(b) == [2.0] * 5
    line = lambda v: {"metrics": {"x": {"value": v}}}
    s = sets.summarise([line(v) for v in a], [line(v) for v in b])["x"]
    assert s["median"] == [3.5, 2.0] and math.isclose(s["b_over_a"], 2.0 / 3.5 - 1)
    assert math.isclose(s["five_times_wider"], 5 * (6.5 - 2.0) / 2.0)
    assert math.isclose(s["farthest_left_out"], ((5.5 - 2.5) / 4.0 + 0.0) / 2)


def test_every_metric_has_a_reader_that_declares_it():
    from bench import spec
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = harness.load_metric(m["name"])
        assert (mod.UNIT, mod.SOURCE) == (m["unit"], m["source"]), m["name"]
        assert mod.LAYER == m.get("layer", "end to end"), m["name"]
        for cell in m.get("workloads", []):
            spec.workload(cell)
