"""The port's simulators (the heap, struct and round event cores, pipeline
and cluster, and the frozen tick baseline) are copies of the reference's and
must replay it event for event.  The golden traces' numbers are pinned here
against the port, and every latency stream must be byte-equal to the
reference's on the same scenario.  Each scenario is built once from each
package's own classes; request ids count per package and are never
compared."""
import numpy as np
import pytest

from repro.core import cluster as JCL
from repro.core import paper_profiles as JPP
from repro.core import pipeline as JP
from repro.core import simulator as JS
from repro.core import simulator_legacy as JSL
from repro.core import trace as JTR
from repro.serving import batching as JB
from repro.serving import request as JR
from repro_torch.core import cluster as TCL
from repro_torch.core import paper_profiles as TPP
from repro_torch.core import pipeline as TP
from repro_torch.core import simulator as TS
from repro_torch.core import simulator_legacy as TSL
from repro_torch.core import trace as TTR
from repro_torch.serving import batching as TB
from repro_torch.serving import request as TR

REF = dict(P=JP, CL=JCL, PP=JPP, S=JS, SL=JSL, TR=JTR, B=JB, R=JR)
PORT = dict(P=TP, CL=TCL, PP=TPP, S=TS, SL=TSL, TR=TTR, B=TB, R=TR)
CORES = ("heap", "struct", "round")
CLUSTER_CORE = {"heap": "ClusterSimulator", "struct": "StructClusterSimulator",
                "round": "RoundClusterSimulator"}
PIPELINE_CORE = {"heap": "PipelineSimulator", "struct": "StructPipelineSimulator",
                 "round": "RoundPipelineSimulator"}


# ---------------------------------------------------------------------------
# the golden clusters (tests/test_simulator_equivalence.py, on package m)
# ---------------------------------------------------------------------------
def golden_cluster(m, hetero=False):
    P = m["P"]

    def coeffs(l1):
        return (0.0, l1 * 0.7, l1 * 0.3)

    def mk(name, lat1, lat2):
        if hetero:
            a1 = P.ModelVariant(f"{name}a1", 75.0, 2, coeffs(2 * lat1), device_profiles=(
                P.DeviceProfile("cpu", coeffs(2 * lat1), 2, 75.0),
                P.DeviceProfile("gpu", coeffs(2 * lat1 / 4.0), 1, 78.0)))
        else:
            a1 = P.ModelVariant(f"{name}a1", 75.0, 2, coeffs(2 * lat1))
        s1 = P.StageModel(f"{name}_a", (P.ModelVariant(f"{name}a0", 60.0, 1, coeffs(lat1)), a1),
                          sla=5 * lat1, batch_choices=(1, 2, 4))
        s2 = P.StageModel(f"{name}_b", (P.ModelVariant(f"{name}b0", 70.0, 1, coeffs(lat2)),),
                          sla=5 * lat2, batch_choices=(1, 2, 4))
        return P.PipelineModel(name, (s1, s2))
    pipes = (mk("p0", 0.05, 0.03), mk("p1", 0.04, 0.02), mk("p2", 0.06, 0.035))
    if hetero:
        return m["CL"].ClusterModel("golden_hetero", pipes, cores={"cpu": 40.0, "gpu": 4.0})
    return m["CL"].ClusterModel("golden", pipes, cores=40.0)


def replay_golden(m, core, hetero=False):
    """The scripted golden run: seeded arrivals on three pipelines, a
    variant upgrade (onto the gpu class when ``hetero``) and a replica grow
    at 5 s, the first superseded mid-window at 6 s."""
    P, cl = m["P"], golden_cluster(m, hetero)
    dev = ("gpu",) if hetero else ()
    cfg0 = m["CL"].ClusterConfig(tuple(
        P.PipelineConfig((P.StageConfig(p.stages[0].variants[0].name, 2, 2),
                          P.StageConfig(p.stages[1].variants[0].name, 2, 1)))
        for p in cl.pipelines))
    sim = getattr(m["S"], CLUSTER_CORE[core])(cl, cfg0, adaptation_delay=1.5)
    for p, rate in enumerate((18.0, 90.0, 12.0)):
        for t in m["TR"].arrivals_from_rates(np.full(12, rate), seed=(200 if hetero else 100) + p):
            sim.inject(m["R"].Request(arrival=float(t), sla=cl.pipelines[p].sla), p)
    sim.run_until(5.0)
    sim.reconfigure_pipeline(0, P.PipelineConfig(
        (P.StageConfig("p0a1", 2, 3, *dev), P.StageConfig("p0b0", 2, 1))))
    sim.reconfigure_pipeline(1, P.PipelineConfig(
        (P.StageConfig("p1a0", 2, 3), P.StageConfig("p1b0", 2, 2))))
    sim.run_until(6.0)
    sim.reconfigure_pipeline(0, P.PipelineConfig(
        (P.StageConfig("p0a1", 4, 2, *dev), P.StageConfig("p0b0", 2, 1))))
    sim.run_until(12 + 60 * max(sim.sla_of))
    return sim


def cluster_record(sim):
    """Everything a golden cluster run decides, as plain values."""
    return dict(
        log=tuple(sim.reconfig_log), n_reconfigs=sim.n_reconfigs,
        totals=tuple((m.arrived, m.completed, m.dropped) for m in sim.metrics_by_pipe),
        events=sim.events_processed, queued=sim.queued, in_service=sim.in_service,
        peak_by_class=sim.peak_serving_by_class, peak=sim.peak_serving_cores,
        alloc_vec=sim._alloc_vec, serving_vec=sim._serving_vec,
        latencies=tuple(m.latencies.tobytes() for m in sim.metrics_by_pipe))


@pytest.mark.parametrize("core", CORES)
def test_golden_cluster_trace(core):
    got = cluster_record(replay_golden(PORT, core))
    assert got["log"] == ((5.0, 0, 6.5), (5.0, 1, 6.5), (6.0, 0, 7.5))
    assert got["n_reconfigs"] == 3
    assert got["totals"] == ((241, 241, 0), (1107, 334, 773), (132, 132, 0))
    assert got["events"] == 3325
    assert got["queued"] == 0 and got["in_service"] == 0
    assert got == cluster_record(replay_golden(REF, core))


@pytest.mark.parametrize("core", CORES)
def test_golden_hetero_cluster_trace(core):
    got = cluster_record(replay_golden(PORT, core, hetero=True))
    assert got["log"] == ((5.0, 0, 6.5), (5.0, 1, 6.5), (6.0, 0, 7.5))
    assert got["n_reconfigs"] == 3
    assert got["totals"] == ((223, 223, 0), (1117, 336, 781), (126, 126, 0))
    assert got["events"] == 3345
    assert got["queued"] == 0 and got["in_service"] == 0
    assert got["serving_vec"][0] == (1.0, 2.0)
    assert got["alloc_vec"][0] == (1.0, 2.0)
    assert got["serving_vec"][1][1] == 0.0 and got["serving_vec"][2][1] == 0.0
    assert got["peak_by_class"] == (11.0, 2.0)
    assert got == cluster_record(replay_golden(REF, core, hetero=True))


# ---------------------------------------------------------------------------
# the golden video fan-out trace (tests/test_dag_simulator.py)
# ---------------------------------------------------------------------------
def replay_video_fanout(m, core):
    P = m["P"]
    pipe = m["PP"].video_fanout()
    cfg1 = P.PipelineConfig((P.StageConfig("decode-fixed", 1, 1), P.StageConfig("yolov5m", 4, 2),
                             P.StageConfig("resnet50", 4, 2), P.StageConfig("fusion-fixed", 1, 1)))
    cfg2 = P.PipelineConfig((P.StageConfig("decode-fixed", 1, 1), P.StageConfig("yolov5s", 2, 3),
                             P.StageConfig("resnet34", 2, 2), P.StageConfig("fusion-fixed", 1, 1)))
    rng = np.random.default_rng(42)
    times = np.cumsum(rng.exponential(1 / 12.0, 600))
    sim = getattr(m["S"], PIPELINE_CORE[core])(pipe, cfg1, drop_factor=1.2, max_wait=0.3)
    sim.lam_est = 12.0
    sim.inject_arrivals(times)
    sim.run_until(float(times[-1]) + 10.0)
    sim.reconfigure(cfg2)
    t2 = np.cumsum(rng.exponential(1 / 12.0, 200)) + sim.now
    sim.inject_arrivals(t2)
    sim.run_until(float(t2[-1]) + 10.0)
    return sim


@pytest.mark.parametrize("core", CORES)
def test_golden_video_fanout_trace(core):
    sim = replay_video_fanout(PORT, core)
    m = sim.metrics
    assert (m.arrived, m.completed, m.dropped) == (800, 794, 6)
    assert sim.events_processed == 4210
    assert sim.n_reconfigs == 1
    assert float(m.latencies.sum()) == 713.0026923255647
    assert float(m.latencies.max()) == 1.7732977636746003
    assert sim.queued == 0 and sim.in_service == 0
    ref = replay_video_fanout(REF, core)
    assert m.latencies.tobytes() == ref.metrics.latencies.tobytes()
    assert sim.events_processed == ref.events_processed


# ---------------------------------------------------------------------------
# single-pipeline replays, and the tick baseline
# ---------------------------------------------------------------------------
def two_stage(m, lat1=0.05, lat2=0.03):
    P = m["P"]

    def var(name, l1, acc, alloc=1):
        return P.ModelVariant(name, acc, alloc, (0.0, l1 * 0.7, l1 * 0.3))
    s1 = P.StageModel("a", (var("a0", lat1, 60.0), var("a1", 2 * lat1, 75.0, 2)),
                      sla=5 * lat1, batch_choices=(1, 2, 4))
    s2 = P.StageModel("b", (var("b0", lat2, 70.0),), sla=5 * lat2, batch_choices=(1, 2, 4))
    return P.PipelineModel("tiny", (s1, s2))


# (stage configs, rate per second for 12 s, arrivals seed): full batches,
# lone requests timing out, overload with drops, moderate Poisson load
TRACES = {
    "linspace_full": ((("a0", 4, 2), ("b0", 2, 2)), None, None),
    "sparse_timeout": ((("a0", 4, 1), ("b0", 4, 1)), None, None),
    "overload_drops": ((("a0", 1, 1), ("b0", 1, 1)), 50.0, 1),
    "poisson_mid": ((("a0", 2, 3), ("b0", 2, 2)), 12.0, 4),
}


def trace_inputs(m, name):
    P = m["P"]
    stages, rate, seed = TRACES[name]
    cfg = P.PipelineConfig(tuple(P.StageConfig(*s) for s in stages))
    if name == "linspace_full":
        arr = np.linspace(0, 2, 64)
    elif name == "sparse_timeout":
        arr = np.array([0.0, 3.0, 6.0, 9.0])
    else:
        arr = m["TR"].arrivals_from_rates(np.full(12, rate), seed=seed)
    return two_stage(m), cfg, arr


def replay(m, cls, name, horizon=40.0, reconfig=False):
    pipe, cfg, arrivals = trace_inputs(m, name)
    sim = cls(pipe, cfg)
    for t in arrivals:
        sim.inject(m["R"].Request(arrival=float(t), sla=pipe.sla))
    if reconfig:
        sim.run_until(4.0)
        sim.reconfigure(m["P"].PipelineConfig(
            (m["P"].StageConfig("a1", 2, 2), m["P"].StageConfig("b0", 1, 3))))
    sim.run_until(horizon)
    return sim


@pytest.mark.parametrize("name", sorted(TRACES))
def test_legacy_tick_simulator_as_the_reference(name):
    """The frozen tick baseline, and the heap core against it as the
    reference's equivalence harness holds it."""
    got = replay(PORT, TSL.LegacyTickSimulator, name)
    want = replay(REF, JSL.LegacyTickSimulator, name)
    g, w = got.metrics, want.metrics
    assert (g.arrived, g.completed, g.dropped) == (w.arrived, w.completed, w.dropped)
    assert np.asarray(g.latencies).tobytes() == np.asarray(w.latencies).tobytes()
    assert g.sla_violations(0.5) == w.sla_violations(0.5)
    new = replay(PORT, TS.PipelineSimulator, name).metrics
    assert (new.completed, new.dropped, new.arrived) == (g.completed, g.dropped, g.arrived)


@pytest.mark.parametrize("core", CORES)
@pytest.mark.parametrize("name", sorted(TRACES))
def test_pipeline_cores_as_the_reference(name, core):
    """Each event core on one pipeline, with a reconfiguration mid-trace."""
    def rec(m):
        sim = replay(m, getattr(m["S"], PIPELINE_CORE[core]), name, reconfig=True)
        mt = sim.metrics
        return (mt.arrived, mt.completed, mt.dropped, sim.events_processed,
                sim.n_reconfigs, mt.latencies.tobytes(), mt.sla_violations(0.3))
    got, want = rec(PORT), rec(REF)
    assert got == want
    assert got[0] > 0


@pytest.mark.parametrize("core", CORES)
def test_make_cluster_simulator_with_bulk_injection_and_pool(core):
    """``make_cluster_simulator`` picks the same core; bulk injection draws
    requests from a ``RequestPool`` and recycles them."""
    def rec(m):
        cl = golden_cluster(m)
        cfg = m["CL"].ClusterConfig(tuple(
            m["P"].PipelineConfig((m["P"].StageConfig(p.stages[0].variants[0].name, 2, 2),
                                   m["P"].StageConfig(p.stages[1].variants[0].name, 2, 1)))
            for p in cl.pipelines))
        sim = m["S"].make_cluster_simulator(cl, cfg, event_core=core,
                                            request_pool=m["R"].RequestPool())
        for p in range(3):
            sim.set_lam_est(p, 10.0)
            sim.inject_arrivals(m["TR"].arrivals_from_rates(np.full(8, 10.0 + 5 * p), seed=p),
                                pipeline=p)
        sim.run_until(30.0)
        return (type(sim).__name__, sim.events_processed,
                tuple((x.arrived, x.completed, x.dropped, x.latencies.tobytes())
                      for x in sim.metrics_by_pipe))
    got, want = rec(PORT), rec(REF)
    assert got == want


# ---------------------------------------------------------------------------
# serving/request and serving/batching
# ---------------------------------------------------------------------------
def test_request_pool_and_central_queue_as_the_reference():
    def run(m):
        pool = m["R"].RequestPool()
        reqs = pool.acquire_many(np.linspace(0.0, 1.0, 11), sla=0.4)
        q = m["B"].CentralQueue(batch_size=4, max_wait=0.25)
        out = []
        for r in reqs:
            q.push(r)
            now = r.arrival + 0.01
            out.append((len(q), q.ready(now), q.oldest_wait(now)))
            if q.ready(now):
                out.append([b.arrival for b in q.pop_batch(now)])
        q.reconfigure(2, max_wait=0.1)
        dropped = q.drain_expired(2.0, stage=1, drop_factor=2.0)
        out.append([(d.arrival, d.dropped_at, d.done, d.dropped, d.latency) for d in dropped])
        out.append(len(q))
        pool.release_many(reqs)
        again = pool.acquire(5.0, sla=1.0)
        out.append((again.arrival, again.sla, bool(np.isnan(again.done)), again.dropped))
        return out
    assert run(PORT) == run(REF)
