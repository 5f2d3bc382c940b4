"""The port's numpy-only control-plane modules (pipeline, queueing,
profiler) are copies of the reference's and must give bit-identical
results; ``profile_stage_server`` drives the torch engine."""
import dataclasses

import numpy as np
import pytest

from repro.core import pipeline as JP
from repro.core import profiler as JPF
from repro.core import queueing as JQ
from repro_torch import configs as TC
from repro_torch.core import pipeline as TP
from repro_torch.core import profiler as TPF
from repro_torch.core import queueing as TQ
from repro_torch.serving.engine import StageServer


def _profiles(mod, seed, n=3, batches=(1, 2, 4, 8)):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a, b, c = rng.uniform(1e-4, 2e-3), rng.uniform(1e-3, 2e-2), rng.uniform(5e-3, 5e-2)
        lats = [a * x * x + b * x + c + rng.normal(0, 1e-4) for x in batches]
        out.append(mod.Profile(f"v{i}", list(batches), lats, 60.0 + 5 * i,
                               params_m=1.5 * i))
    return out


def _as_dict(obj):
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("th", [2.0, 20.0])
def test_build_stage_bit_identical(seed, th):
    """As ``launch/serve.py`` calls it: the profiled batches are the
    choices and the largest of them bounds the SLA check."""
    kw = dict(th=th, batch_choices=(1, 2, 4, 8), max_batch=8)
    want = JPF.build_stage("s", _profiles(JPF, seed), **kw)
    got = TPF.build_stage("s", _profiles(TPF, seed), **kw)
    assert _as_dict(got) == _as_dict(want)
    assert len(got.variants) >= 1


def test_build_stage_refuses_alike_when_no_variant_fits():
    with pytest.raises(ValueError, match="no variant") as want:
        JPF.build_stage("s", _profiles(JPF, 0), th=1e4)
    with pytest.raises(ValueError, match="no variant") as got:
        TPF.build_stage("s", _profiles(TPF, 0), th=1e4)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", range(3))
def test_fits_sla_and_base_allocation_bit_identical(seed):
    jp, tp = _profiles(JPF, seed), _profiles(TPF, seed)
    assert TPF.derive_stage_sla(tp) == JPF.derive_stage_sla(jp)
    for j, t in zip(jp, tp):
        assert t.coeffs() == j.coeffs()
        assert TPF.fit_mse(t.batches, t.latencies, t.coeffs()) == \
            JPF.fit_mse(j.batches, j.latencies, j.coeffs())
        assert TPF.fit_linear_mse(t.batches, t.latencies) == \
            JPF.fit_linear_mse(j.batches, j.latencies)
        for th in (0.5, 5.0, 50.0):
            assert TPF.base_allocation(t, th, 1.0) == JPF.base_allocation(j, th, 1.0)


def _pipeline(mod, seed, parents=None):
    rng = np.random.default_rng(seed)
    stages = []
    for s in range(3):
        variants = tuple(
            mod.ModelVariant(f"s{s}v{v}", float(rng.uniform(50, 90)), int(rng.integers(1, 8)),
                             tuple(float(x) for x in rng.uniform(1e-4, 5e-2, 3)))
            for v in range(3))
        stages.append(mod.StageModel(f"s{s}", variants, sla=float(rng.uniform(0.2, 2.0))))
    return mod.PipelineModel("p", tuple(stages), parents=parents)


@pytest.mark.parametrize("parents", [None, ((), (0,), (0, 1))])
@pytest.mark.parametrize("latency_model", ["worst_case", "expected"])
def test_pipeline_latency_cost_supports_bit_identical(parents, latency_model):
    for seed in range(5):
        jpipe, tpipe = _pipeline(JP, seed, parents), _pipeline(TP, seed, parents)
        assert tpipe.sla == jpipe.sla and tpipe.paths() == jpipe.paths()
        rng = np.random.default_rng(100 + seed)
        for _ in range(10):
            picks = [(f"s{s}v{int(rng.integers(3))}", int(rng.choice([1, 2, 4, 8])),
                      int(rng.integers(1, 5))) for s in range(3)]
            jc = JP.PipelineConfig(tuple(JP.StageConfig(*p) for p in picks))
            tc = TP.PipelineConfig(tuple(TP.StageConfig(*p) for p in picks))
            lam = float(rng.uniform(0.5, 40.0))
            assert tc.latency(tpipe, lam, latency_model) == \
                jc.latency(jpipe, lam, latency_model)
            assert tc.cost(tpipe) == jc.cost(jpipe)
            assert tc.supports(tpipe, lam) == jc.supports(jpipe, lam)


def test_queueing_bit_identical():
    for b in (1, 2, 4, 8, 16):
        for lam in (0.5, 3.0, 40.0):
            assert TQ.queue_delay(b, lam) == JQ.queue_delay(b, lam)
            for reps in (1, 3):
                assert TQ.expected_wait(b, lam, reps, 0.05) == \
                    JQ.expected_wait(b, lam, reps, 0.05)


@pytest.fixture(scope="module")
def profiled():
    fam = TC.get_variant_family("yi-34b")[:2]
    srv = StageServer("yi-34b", fam, gen_tokens=1, device="cpu")
    return fam, TPF.profile_stage_server(srv, batches=(1, 2), prompt_len=4, repeats=1)


def test_profile_stage_server_drives_the_torch_engine(profiled):
    fam, profs = profiled
    assert [p.name for p in profs] == [name for name, _, _ in fam]
    assert [p.accuracy for p in profs] == [acc for _, _, acc in fam]
    for p in profs:
        assert p.batches == [1, 2] and len(p.latencies) == 2
        assert all(lat > 0 for lat in p.latencies)
    stage = TPF.build_stage("yi-34b", profs, th=0.01, batch_choices=(1, 2),
                            max_batch=2)
    assert isinstance(stage, TP.StageModel) and stage.variants
