"""The port's planner (accuracy, paper_profiles, optimizer, baselines,
cluster) is a copy of the reference's numpy code and must decide exactly as
it does: the same config and the same objective, PAS, cost and latency
floats, on the same inputs.  Every scenario is built twice, once from each
package's own classes; only plain values are compared.  ``solve_enum`` is
the one part written anew (in torch, float32 as the reference's jnp): its
picks must be the reference's."""
import dataclasses
import functools

import numpy as np
import pytest

from repro.core import accuracy as JACC
from repro.core import baselines as JBL
from repro.core import cluster as JCL
from repro.core import optimizer as JOPT
from repro.core import paper_profiles as JPP
from repro.core import pipeline as JP
from repro_torch.core import accuracy as TACC
from repro_torch.core import baselines as TBL
from repro_torch.core import cluster as TCL
from repro_torch.core import optimizer as TOPT
from repro_torch.core import paper_profiles as TPP
from repro_torch.core import pipeline as TP

REF = dict(P=JP, CL=JCL, OPT=JOPT, BL=JBL, PP=JPP, ACC=JACC)
PORT = dict(P=TP, CL=TCL, OPT=TOPT, BL=TBL, PP=TPP, ACC=TACC)
METRICS = ("pas", "pas_prime", "log_pas")


def _both(fn):
    """``fn`` run once on each package's modules: (reference, port)."""
    return fn(REF), fn(PORT)


def random_pipeline(m, seed, n_stages=None, n_variants=None, dag=False):
    """``tests/test_optimizer.py::random_pipeline`` on package ``m``; with
    ``dag`` the stages fan out from the first and join at the last."""
    rng = np.random.default_rng(seed)
    n_stages = n_stages or int(rng.integers(1, 4))
    stages = []
    for s in range(n_stages):
        nv = n_variants or int(rng.integers(1, 4))
        variants = []
        for v in range(nv):
            l1 = float(rng.uniform(0.01, 0.4))
            variants.append(m["P"].ModelVariant(
                name=f"s{s}v{v}",
                accuracy=float(rng.uniform(30, 95)),
                base_alloc=int(rng.choice([1, 2, 4, 8])),
                latency_coeffs=(l1 * 0.001, l1 * 0.6, l1 * 0.4)))
        sla = float(5.0 * np.mean([v.latency(1) for v in variants]))
        stages.append(m["P"].StageModel(f"stage{s}", tuple(variants), sla,
                                        batch_choices=(1, 2, 4, 8)))
    parents = None
    if dag:
        parents = ((),) + tuple((0,) for _ in range(n_stages - 2)) \
            + (tuple(range(1, n_stages - 1)),)
    return m["P"].PipelineModel("rand", tuple(stages), parents=parents)


def plain(sol):
    """A ``Solution`` as plain values, without its wall-clock field."""
    d = dataclasses.asdict(sol)
    d.pop("solve_time")
    return d


def plain_cluster(sol):
    return (None if sol.config is None else dataclasses.asdict(sol.config),
            [plain(s) for s in sol.per_pipeline], sol.objective, sol.cost,
            sol.feasible, sol.solver, sol.n_switches)


# ---------------------------------------------------------------------------
# per-pipeline solvers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("seed", range(6))
def test_vec_and_brute_pick_as_the_reference(seed, metric):
    def run(m):
        pipe = random_pipeline(m, seed)
        obj = m["OPT"].Objective(alpha=2.0, beta=0.7, delta=1e-5, metric=metric)
        out = []
        for lam in (0.5, 4.0, 17.0, 60.0):
            out.append((plain(m["OPT"].solve_vec(pipe, lam, obj)),
                        plain(m["OPT"].solve_brute(pipe, lam, obj))))
        return out
    want, got = _both(run)
    assert got == want
    assert any(v["feasible"] for v, _ in got)


@pytest.mark.parametrize("seed", range(4))
def test_dag_pipelines_pick_as_the_reference(seed):
    """Fan-out / join pipelines take the critical-path latency branch."""
    def run(m):
        pipe = random_pipeline(m, 100 + seed, n_stages=4, n_variants=2, dag=True)
        obj = m["OPT"].Objective(alpha=2.0, beta=0.3, delta=1e-5)
        return [(plain(m["OPT"].solve_vec(pipe, lam, obj)),
                 plain(m["OPT"].solve_brute(pipe, lam, obj)))
                for lam in (1.0, 8.0, 25.0)]
    want, got = _both(run)
    assert got == want


@pytest.mark.parametrize("metric", ("pas", "pas_prime", "log_pas"))
@pytest.mark.parametrize("seed", range(4))
def test_milp_picks_as_the_reference(seed, metric):
    def run(m):
        pipe = random_pipeline(m, 200 + seed)
        obj = m["OPT"].Objective(alpha=3.0, beta=0.5, delta=1e-5, metric=metric)
        return [plain(m["OPT"].solve_milp(pipe, lam, obj)) for lam in (2.0, 15.0, 40.0)]
    want, got = _both(run)
    assert got == want


@pytest.mark.parametrize("preset", ("video", "nlp"))
def test_paper_presets_pick_as_the_reference(preset):
    """The paper's pipelines (Appendix B weights), every solver and the
    ``auto`` dispatch, over the Fig.-7 rate range."""
    def run(m):
        pipe = m["PP"].PIPELINES[preset]()
        obj = m["OPT"].Objective(**m["PP"].PAPER_WEIGHTS[preset])
        lin = m["OPT"].Objective(**m["PP"].PAPER_WEIGHTS[preset], metric="pas_prime")
        out = []
        for lam in (2.0, 8.0, 20.0, 40.0):
            out.append(tuple(plain(s) for s in (
                m["OPT"].solve_vec(pipe, lam, obj),
                m["OPT"].solve_brute(pipe, lam, obj),
                m["OPT"].solve(pipe, lam, obj),
                m["OPT"].solve_milp(pipe, lam, lin),
                m["OPT"].solve_vec(pipe, lam, obj, latency_model="expected"))))
        return out
    want, got = _both(run)
    assert got == want
    assert all(v["feasible"] for row in got for v in row[:3])


@pytest.mark.parametrize("name", sorted(set(JPP.PIPELINES) | set(JPP.DAG_PIPELINES)))
def test_paper_profiles_build_the_reference_tables(name):
    def build(m):
        fn = {**m["PP"].PIPELINES, **m["PP"].DAG_PIPELINES}[name]
        return dataclasses.asdict(fn())
    want, got = _both(build)
    assert got == want


@pytest.mark.parametrize("seed", range(3))
def test_accuracy_metrics_as_the_reference(seed):
    def run(m):
        pipe = random_pipeline(m, 300 + seed, n_stages=3, n_variants=3)
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(5):
            cfg = m["P"].PipelineConfig(tuple(
                m["P"].StageConfig(s.variants[int(rng.integers(len(s.variants)))].name,
                                   int(rng.choice(s.batch_choices)), int(rng.integers(1, 5)))
                for s in pipe.stages))
            out.append((m["ACC"].pas_of(cfg, pipe), m["ACC"].pas_prime_of(cfg, pipe),
                        m["OPT"].evaluate_config(pipe, cfg, 6.0, m["OPT"].Objective())))
        return [(a, b, None if c is None else dataclasses.asdict(c)) for a, b, c in out]
    want, got = _both(run)
    assert got == want


# ---------------------------------------------------------------------------
# the four policies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", sorted(JBL.POLICIES))
@pytest.mark.parametrize("preset", ("video", "audio-qa", "video-fanout"))
def test_policies_decide_as_the_reference(policy, preset):
    def run(m):
        pipe = {**m["PP"].PIPELINES, **m["PP"].DAG_PIPELINES}[preset]()
        return [plain(m["BL"].POLICIES[policy](pipe, lam)) for lam in (1.0, 6.0, 18.0, 35.0)]
    want, got = _both(run)
    assert got == want


# ---------------------------------------------------------------------------
# cluster level: frontiers, the knapsack, static splits
# ---------------------------------------------------------------------------
def random_cluster(m, seed, cores=None):
    rng = np.random.default_rng(seed)
    pipes = tuple(dataclasses.replace(
        random_pipeline(m, 400 + 10 * seed + i, n_stages=2, n_variants=3), name=f"p{i}")
        for i in range(3))
    return m["CL"].ClusterModel("rand", pipes,
                                cores if cores is not None else float(rng.integers(12, 60)))


def hetero_cluster(m, seed):
    """Two class cluster: each variant also has a gpu build, 4x faster at
    one unit with +3 accuracy, under a small gpu budget."""
    rng = np.random.default_rng(seed)
    P = m["P"]
    pipes = []
    for i in range(2):
        stages = []
        for s in range(2):
            vs = []
            for v in range(2):
                l1 = float(rng.uniform(0.02, 0.2))
                acc = float(rng.uniform(40, 90))
                alloc = int(rng.choice([1, 2, 4]))
                co = (l1 * 0.002, l1 * 0.7, l1 * 0.3)
                vs.append(P.ModelVariant(f"p{i}s{s}v{v}", acc, alloc, co, device_profiles=(
                    P.DeviceProfile("cpu", co, alloc, acc),
                    P.DeviceProfile("gpu", tuple(c / 4.0 for c in co), 1, acc + 3.0))))
            sla = float(5.0 * np.mean([v.latency(1) for v in vs]))
            stages.append(P.StageModel(f"p{i}s{s}", tuple(vs), sla, batch_choices=(1, 2)))
        pipes.append(P.PipelineModel(f"p{i}", tuple(stages)))
    return m["CL"].ClusterModel("hc", tuple(pipes), cores={"cpu": 24.0, "gpu": 5.0})


@pytest.mark.parametrize("seed", range(4))
def test_solve_cluster_picks_as_the_reference(seed):
    def run(m):
        cl = random_cluster(m, seed)
        obj = m["OPT"].Objective(alpha=1.0, beta=0.05)
        lams = [3.0 + 4 * seed, 9.0, 14.0 - seed]
        inc = m["OPT"].solve_cluster(cl, [0.6 * x + 1.0 for x in lams], obj)
        out = [plain_cluster(inc),
               plain_cluster(m["OPT"].solve_cluster(cl, lams, obj)),
               plain_cluster(m["OPT"].solve_cluster(cl, lams, obj, sla_weights=(2.0, 1.0, 0.5)))]
        if inc.feasible:
            for sc, sb in ((0.5, None), (2.0, 1), (5.0, 0)):
                out.append(plain_cluster(m["OPT"].solve_cluster(
                    cl, lams, obj, current=inc.config, switch_cost=sc, switch_budget=sb)))
            out.append(plain_cluster(m["OPT"].solve_cluster(
                cl, lams, obj, current=inc.config, switch_cost=1.0, overlap=True)))
        # the cross-product oracle, on two of the pipelines to stay fast
        sub = m["CL"].ClusterModel("sub", cl.pipelines[:2], cl.cores)
        out.append(plain_cluster(m["OPT"].solve_cluster_brute(sub, lams[:2], obj)))
        return out
    want, got = _both(run)
    assert got == want
    assert len(got) > 4


@pytest.mark.parametrize("seed", range(3))
def test_solve_cluster_device_class_budget_as_the_reference(seed):
    def run(m):
        cl = hetero_cluster(m, seed)
        obj = m["OPT"].Objective(alpha=1.0, beta=0.05)
        lams = [4.0 + 3 * seed, 7.0]
        k = m["OPT"].solve_cluster(cl, lams, obj, max_replicas=4)
        out = [plain_cluster(k),
               plain_cluster(m["OPT"].solve_cluster_brute(cl, lams, obj, max_replicas=4))]
        if k.feasible:
            out.append(plain_cluster(m["OPT"].solve_cluster(
                cl, [x + 2.0 for x in lams], obj, max_replicas=4, current=k.config,
                switch_cost=0.7, switch_budget=1)))
        out.append(m["CL"].proportional_split_by_class(cl, lams))
        return out
    want, got = _both(run)
    assert got == want
    assert got[0][4], "the device-class knapsack found nothing to compare"


@pytest.mark.parametrize("policy", sorted(JBL.CLUSTER_POLICIES))
def test_cluster_policies_decide_as_the_reference(policy):
    def run(m):
        cl = random_cluster(m, 7, cores=40.0)
        obj = m["OPT"].Objective(alpha=1.0, beta=0.05)
        return [plain_cluster(m["BL"].CLUSTER_POLICIES[policy](cl, lams, obj=obj))
                for lams in ([2.0, 5.0, 9.0], [12.0, 3.0, 20.0])]
    want, got = _both(run)
    assert got == want


@pytest.mark.parametrize("seed", range(3))
def test_pareto_frontier_and_cache_as_the_reference(seed):
    def run(m):
        pipe = random_pipeline(m, 500 + seed, n_stages=3, n_variants=3)
        obj = m["OPT"].Objective(alpha=2.0, beta=0.2)
        cache = m["OPT"].FrontierCache()
        out = []
        for lam in (3.0, 11.0, 3.0):
            front = m["OPT"].pareto_frontier(pipe, lam, obj)
            vec = m["OPT"].pareto_frontier_vec(pipe, lam, obj, ("cpu",))
            out.append(([(p.cost, p.objective) for p in front],
                        [(p.cost, p.objective) for p in vec],
                        plain(m["OPT"].solve_capped(pipe, lam, obj, cost_cap=12.0, cache=cache))))
        return out, dict(cache.stats)
    want, got = _both(run)
    assert got == want


# ---------------------------------------------------------------------------
# solve_enum: the float32 enumeration, in torch on a device (the CPU here)
# ---------------------------------------------------------------------------
def _enum(m, pipe, lam, obj, **kw):
    if m is PORT:
        kw["device"] = "cpu"
    return m["OPT"].solve_enum(pipe, lam, obj, **kw)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("seed", range(4))
def test_enum_picks_as_the_reference(seed, metric):
    """``tests/test_optimizer.py::test_enum_matches_brute_oracle``'s random
    pipelines: the port's picks are the reference's, and its objective is
    the port's ``solve_brute``'s."""
    rates = (0.5, 9.0, 55.0)

    def run(m):
        pipe = random_pipeline(m, 300 + seed)
        obj = m["OPT"].Objective(alpha=2.0, beta=0.7, delta=1e-5, metric=metric)
        return [plain(_enum(m, pipe, lam, obj)) for lam in rates]
    want, got = _both(run)
    assert got == want
    pipe = random_pipeline(PORT, 300 + seed)
    obj = TOPT.Objective(alpha=2.0, beta=0.7, delta=1e-5, metric=metric)
    for lam, e in zip(rates, got):
        b = TOPT.solve_brute(pipe, lam, obj)
        assert e["feasible"] == b.feasible
        if b.feasible:
            assert e["objective"] == pytest.approx(b.objective, rel=1e-9)


@pytest.mark.parametrize("seed", range(3))
def test_enum_dag_pipelines_pick_as_the_reference(seed):
    """Fan-out / join pipelines: latency holds on every path."""
    def run(m):
        pipe = random_pipeline(m, 100 + seed, n_stages=4, n_variants=2, dag=True)
        obj = m["OPT"].Objective(alpha=2.0, beta=0.3, delta=1e-5)
        return [plain(_enum(m, pipe, lam, obj)) for lam in (1.0, 8.0, 25.0)]
    want, got = _both(run)
    assert got == want
    assert any(s["feasible"] for s in got)


def test_enum_presets_pick_as_the_reference():
    """The video preset of ``tests/test_optimizer.py``'s replica, alpha and
    beta tests, and the impossible SLA of its infeasibility test."""
    def run(m):
        pipe = m["PP"].video()
        out = [plain(_enum(m, pipe, 20.0, m["OPT"].Objective()))]
        out += [plain(_enum(m, pipe, 15.0, m["OPT"].Objective(alpha=a, beta=1.0)))
                for a in (0.1, 100.0)]
        out += [plain(_enum(m, pipe, 15.0, m["OPT"].Objective(alpha=1.0, beta=b)))
                for b in (0.01, 10.0)]
        rand = random_pipeline(m, 1)
        tight = m["P"].PipelineModel(rand.name, tuple(
            m["P"].StageModel(s.name, s.variants, sla=1e-6, batch_choices=s.batch_choices)
            for s in rand.stages))
        out.append(plain(_enum(m, tight, 5.0, m["OPT"].Objective())))
        return out
    want, got = _both(run)
    assert got == want
    assert all(s["feasible"] for s in got[:-1]) and not got[-1]["feasible"]


def test_enum_through_solve_and_fa2(monkeypatch):
    """``solve(solver="enum")`` and ``fa2(..., solver="enum")`` reach the
    port's ``solve_enum``, which ``solve`` looks up when it is called."""
    pipe = random_pipeline(PORT, 0)
    on_cpu = functools.partial(TOPT.solve_enum, device="cpu")
    obj = TOPT.Objective()
    want = plain(on_cpu(pipe, 5.0, obj))
    monkeypatch.setattr(TOPT, "solve_enum", on_cpu)
    assert plain(TOPT.solve(pipe, 5.0, obj, solver="enum")) == want
    low = plain(TBL.fa2(pipe, 5.0, "low", solver="enum"))
    assert low == plain(TBL.fa2(pipe, 5.0, "low", solver="vec")) | {"solver": "enum"}
