"""The port's adapter (``run_trace``, ``run_cluster_trace``, ``run_cell``
and the demand modes) and its trace synthesis are copies of the
reference's and must give the same results on the same inputs: the same
interval records, summaries, latency streams and rate arrays, bit for bit.
Wall-clock fields (``solve_time``, ``solver_wall_s``, the cells' ``*wall_s``)
are left out of every comparison."""
import dataclasses
import functools

import numpy as np
import pytest

from repro.core import adapter as JAD
from repro.core import cluster as JCL
from repro.core import optimizer as JOPT
from repro.core import paper_profiles as JPP
from repro.core import pipeline as JP
from repro.core import trace as JTR
from repro_torch.core import adapter as TAD
from repro_torch.core import cluster as TCL
from repro_torch.core import optimizer as TOPT
from repro_torch.core import paper_profiles as TPP
from repro_torch.core import pipeline as TP
from repro_torch.core import trace as TTR
from test_torch_simulator import golden_cluster

REF = dict(AD=JAD, CL=JCL, OPT=JOPT, PP=JPP, P=JP, TR=JTR)
PORT = dict(AD=TAD, CL=TCL, OPT=TOPT, PP=TPP, P=TP, TR=TTR)
CORES = ("heap", "struct", "round")
POLICIES = ("ipa", "fa2_low", "fa2_high", "rim")
EXCERPT_S = 120


@pytest.fixture(scope="module")
def excerpts():
    """Each package's own 120 s bursty excerpt (the 21-day trace is built
    once per package and module)."""
    return {id(m): m["TR"].excerpt("bursty", EXCERPT_S) for m in (REF, PORT)}


def trace_record(res):
    """A ``TraceResult`` as plain values, without its wall-clock fields."""
    return dict(
        summary=res.summary(),
        intervals=[dataclasses.astuple(dataclasses.replace(r, solve_time=0.0))
                   for r in res.intervals],
        latencies=res.latencies.tobytes(), arrived=res.arrived, completed=res.completed,
        dropped=res.dropped, sla=res.sla, sim_events=res.sim_events,
        peak_queue_depth=res.peak_queue_depth)


def cluster_trace_record(res):
    return dict(
        summary=res.summary(), budget=res.budget, sim_events=res.sim_events,
        peak_queue_depth=res.peak_queue_depth, n_reconfigs=res.n_reconfigs,
        reconfig_log=list(res.reconfig_log), peak_serving_cores=res.peak_serving_cores,
        frontier_cache_stats=res.frontier_cache_stats,
        per_pipeline=[trace_record(r) for r in res.per_pipeline])


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", JTR.EXCERPTS)
def test_excerpt_bit_identical(kind):
    want = JTR.excerpt(kind, EXCERPT_S)
    got = TTR.excerpt(kind, EXCERPT_S)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("kind", JTR.SCALE_EXCERPTS)
def test_scale_excerpt_bit_identical(kind):
    cfg = dict(seed=3, scale=2.5)
    want = JTR.scale_excerpt(kind, 900, JTR.TraceConfig(**cfg))
    got = TTR.scale_excerpt(kind, 900, TTR.TraceConfig(**cfg))
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("cfg", [dict(), dict(seed=5), dict(seed=2, scale=3.0, burst_amp=30.0)])
def test_synth_trace_bit_identical(cfg):
    want = JTR.synth_trace(7200, JTR.TraceConfig(**cfg))
    got = TTR.synth_trace(7200, TTR.TraceConfig(**cfg))
    assert got.tobytes() == want.tobytes()
    assert len(got) == 7200


@pytest.mark.parametrize("seed", [0, 7, "seedsequence", "generator"])
def test_arrivals_from_rates_bit_identical(seed):
    rates = np.abs(np.sin(np.arange(90) / 7.0)) * 20.0 + 0.5

    def make(s):
        if s == "seedsequence":
            return np.random.SeedSequence(11).spawn(3)[2]
        if s == "generator":
            return np.random.default_rng(13)
        return s
    want = JTR.arrivals_from_rates(rates, seed=make(seed))
    got = TTR.arrivals_from_rates(rates, seed=make(seed))
    assert got.tobytes() == want.tobytes()
    assert len(got) > 500


def test_bounded_trace_cache_as_the_reference():
    def run(TR):
        cache = TR.BoundedTraceCache(max_entries=2)
        seen = []
        for s in (0, 1, 0, 2, 1):
            cfg = TR.TraceConfig(seed=s)
            seen.append(cache.get(cfg, lambda c: TR.synth_trace(60, c)).tobytes())
        return seen, cache.hits, cache.misses, len(cache)
    assert run(TTR) == run(JTR)


@pytest.mark.parametrize("t0", [0.0, 30.0, 95.0])
def test_demand_modes_as_the_reference(t0, excerpts):
    want_r, got_r = excerpts[id(REF)], excerpts[id(PORT)]
    assert TAD.reactive_demand(got_r, t0) == JAD.reactive_demand(want_r, t0)
    assert TAD.burst_demand(got_r, t0) == JAD.burst_demand(want_r, t0)


# ---------------------------------------------------------------------------
# run_trace: the four policies under the three event cores
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("core", CORES)
@pytest.mark.parametrize("policy", POLICIES)
def test_run_trace_as_the_reference(policy, core, excerpts):
    def run(m):
        return trace_record(m["AD"].run_trace(
            m["PP"].video(), excerpts[id(m)], policy=policy, seed=3, event_core=core))
    got, want = run(PORT), run(REF)
    assert got == want
    assert len(got["intervals"]) == EXCERPT_S // 10
    assert got["arrived"] > 500


@pytest.mark.parametrize("solver", ["brute", "milp"])
def test_run_trace_solver_override_as_the_reference(solver, excerpts):
    def run(m):
        obj = m["OPT"].Objective(**m["PP"].PAPER_WEIGHTS["audio-qa"],
                                 **({"metric": "pas_prime"} if solver == "milp" else {}))
        return trace_record(m["AD"].run_trace(
            m["PP"].audio_qa(), excerpts[id(m)], policy="ipa", obj=obj, seed=5,
            solver=solver, interval=20.0))
    assert run(PORT) == run(REF)


def test_enum_solver_override_as_the_reference(excerpts, monkeypatch):
    """``solver="enum"``: the port's float32 torch enumeration on the CPU
    (``solve`` looks ``solve_enum`` up when it is called, so the test hands
    it the device) against the reference's jnp one."""
    monkeypatch.setattr(TOPT, "solve_enum", functools.partial(TOPT.solve_enum, device="cpu"))

    def run(m):
        return trace_record(m["AD"].run_trace(
            m["PP"].video(), excerpts[id(m)][:60], policy="ipa", seed=5,
            solver="enum", interval=20.0))
    got, want = run(PORT), run(REF)
    assert got == want
    assert len(got["intervals"]) == 3


# ---------------------------------------------------------------------------
# run_cluster_trace and run_cell on the golden cluster
# ---------------------------------------------------------------------------
def golden_rates(m):
    return [m["TR"].synth_trace(90, m["TR"].TraceConfig(seed=20 + p, base_rps=8.0 + 4 * p))
            for p in range(3)]


CLUSTER_RUNS = {
    "ipa": dict(policy="ipa"),
    "ipa_switch": dict(policy="ipa", switch_cost=0.5, switch_budget=1,
                       adaptation_delay=4.0, demand_mode="burst"),
    "ipa_weighted": dict(policy="ipa", sla_weights=(2.0, 1.0, 1.0), frontier_cache=None),
    "split_ipa": dict(policy="split_ipa"),
    "split_fa2_low": dict(policy="split_fa2_low"),
    "split_rim": dict(policy="split_rim"),
}


@pytest.mark.parametrize("core", CORES)
@pytest.mark.parametrize("run_name", sorted(CLUSTER_RUNS))
def test_run_cluster_trace_as_the_reference(run_name, core):
    def run(m):
        obj = m["OPT"].Objective(alpha=1.0, beta=0.05)
        return cluster_trace_record(m["AD"].run_cluster_trace(
            golden_cluster(m), golden_rates(m), obj=obj, seed=4, event_core=core,
            **CLUSTER_RUNS[run_name]))
    got, want = run(PORT), run(REF)
    assert got == want
    assert got["summary"]["completed"] > 0


@pytest.mark.parametrize("policy,kw", [("ipa", dict(switch_cost=0.2)),
                                       ("split_fa2_high", dict())])
def test_run_cell_as_the_reference(policy, kw):
    wall = ("wall_s", "solver_wall_s", "sim_wall_s")

    def run(m):
        cell = m["AD"].run_cell(golden_cluster(m), golden_rates(m), policy=policy,
                                seed=np.random.SeedSequence(9), event_core="round", **kw)
        assert all(cell[k] >= 0.0 for k in wall)
        return {k: v for k, v in cell.items() if k not in wall}
    got, want = run(PORT), run(REF)
    assert got == want
    assert got["arrived"] > 0


def test_cluster_knob_misuse_refused_as_the_reference():
    """Switch-cost knobs apply to the joint policy only, in both packages."""
    msgs = []
    for m in (REF, PORT):
        with pytest.raises(ValueError) as err:
            m["AD"].run_cluster_trace(golden_cluster(m), golden_rates(m),
                                      policy="split_ipa", switch_cost=0.5)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
