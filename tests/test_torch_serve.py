"""repro_torch.launch.serve's trace replay against the reference's
``run_trace``, on identical ``PipelineModel``s.

Each package builds the vlm-classify pipeline from the same fixed
``Profile`` lists through its own ``build_stage`` (with the launcher's
th 2.0 and batches 1, 2, 4), and the port's ``replay`` on the launcher's
defaults (bursty, 120 s, x 0.25, alpha 10, beta 0.5, seed 0) must give
what the reference's ``AD.run_trace`` gives on ``TR.excerpt(trace,
seconds) * scale_rps``: every interval, the summary and the event counts,
wall times aside, and a byte-equal latency stream.  Two sets of profiles:

* ``card``: the reduced variants' latency(1) as they were profiled on the
  H100 80GB HBM3 (PERF.md), where every base_alloc is 1, so cost cannot tell
  the variants apart;
* ``apart``: latencies 5 to 40 times longer, so the most accurate variants
  need 4 replicas at th 2 and ``ipa`` and ``fa2_low`` choose differently.

A profile's latency at batch b is latency(1) * (1 + 0.1 (b - 1) + 0.02
(b - 1)^2).  The launcher's ``main`` and the example module run on the CPU
once each with the profiler replaced by these profiles: real profiling is
held by tests/test_torch_profiler.py.
"""
import ast
import json

import pytest

from repro import configs as JC
from repro.core import adapter as JAD
from repro.core import optimizer as JOPT
from repro.core import pipeline as JP
from repro.core import profiler as JPF
from repro.core import trace as JTR
from repro_torch.core import pipeline as TP
from repro_torch.core import profiler as TPF
from repro_torch.examples import serve_pipeline
from repro_torch.launch import serve
from repro_torch.models import model as TM
from test_torch_adapter import trace_record

STAGES = ("phi-3-vision-4.2b", "yi-34b")
# latency(1) of the n, s and m variants in seconds
L1 = {"card": {"phi-3-vision-4.2b": (17.2463e-3, 16.0267e-3, 22.6951e-3),
               "yi-34b": (17.4726e-3, 17.9971e-3, 31.1691e-3)},
      "apart": {"phi-3-vision-4.2b": (0.1, 0.3, 0.9),
                "yi-34b": (0.15, 0.4, 1.1)}}
DEFAULTS = dict(trace="bursty", seconds=120, alpha=10.0, beta=0.5, scale_rps=0.25)


def _latency(l1, b):
    return l1 * (1 + 0.1 * (b - 1) + 0.02 * (b - 1) ** 2)


def _profiles(PF, arch, l1s, batches):
    fam = JC.get_variant_family(arch)
    return [PF.Profile(name, list(batches), [_latency(l1, b) for b in batches], acc)
            for (name, _, acc), l1 in zip(fam, l1s)]


def _pipeline(PF, P, profile_set, th=2.0, batches=(1, 2, 4)):
    stages = tuple(PF.build_stage(arch, _profiles(PF, arch, L1[profile_set][arch], batches),
                                  th=th, batch_choices=batches, max_batch=max(batches))
                   for arch in STAGES)
    return P.PipelineModel("vlm-classify", stages)


def _reference(profile_set, policy, *, trace, seconds, alpha, beta, scale_rps, seed=0,
               th=2.0, batches=(1, 2, 4)):
    pipe = _pipeline(JPF, JP, profile_set, th, batches)
    rates = JTR.excerpt(trace, seconds=seconds) * scale_rps
    return pipe, JAD.run_trace(pipe, rates, policy=policy,
                               obj=JOPT.Objective(alpha=alpha, beta=beta, metric="pas"),
                               seed=seed)


@pytest.mark.parametrize("policy", serve.POLICIES)
@pytest.mark.parametrize("profile_set", ["card", "apart"])
def test_replay_as_the_reference(profile_set, policy):
    _, want = _reference(profile_set, policy, **DEFAULTS)
    got = serve.replay(_pipeline(TPF, TP, profile_set), policy=policy, **DEFAULTS)
    assert trace_record(got) == trace_record(want)
    assert got.summary() == want.summary()
    assert got.completed > 200 and len(got.intervals) == 12


def test_profile_sets_separate_the_policies_only_where_costs_differ():
    allocs = {s: [[v.base_alloc for v in st.variants]
                  for st in _pipeline(TPF, TP, s).stages] for s in L1}
    assert allocs["card"] == [[1, 1, 1], [1, 1, 1]]
    assert allocs["apart"] == [[1, 1, 4], [1, 1, 4]]
    for s in L1:
        pipe = _pipeline(TPF, TP, s)
        ipa, low = (trace_record(serve.replay(pipe, policy=p, **DEFAULTS))["intervals"]
                    for p in ("ipa", "fa2_low"))
        assert (ipa == low) == (s == "card")


@pytest.fixture(scope="module")
def warm_torch():
    """The process's first model init on the CPU takes about a second of
    one-time set-up; take it before the timed tests."""
    TM.init(serve.configs.get_config("yi-34b", reduced=True), device="cpu")


@pytest.fixture
def fixed_profiles(monkeypatch, warm_torch):
    """The card profiles in place of measuring the StageServers."""
    def profile(server, batches=(1, 2, 4, 8), **kw):
        return _profiles(TPF, server.name, L1["card"][server.name], batches)
    monkeypatch.setattr(TPF, "profile_stage_server", profile)


def test_main_replays_and_serves(fixed_profiles, capsys):
    serve.main(["--device", "cpu", "--seconds", "60", "--policy", "fa2_low"])
    text = capsys.readouterr().out
    pipe, want = _reference("card", "fa2_low", **dict(DEFAULTS, seconds=60))
    lines = text.splitlines()
    sla = lines.index(f"pipeline SLA_P = {pipe.sla:.6f} s")
    start, end = lines.index("{"), lines.index("}")
    assert sla < start
    assert json.loads("\n".join(lines[start:end + 1])) == want.summary()
    last = want.intervals[-1]
    assert lines[end + 1] == f"final interval PAS={last.pas:.2f} cost={last.cost:.0f}"
    assert lines[end + 2].startswith("engine batch 0: tokens ")


def test_example_replays_and_serves(fixed_profiles, capsys):
    serve_pipeline.main(["--device", "cpu"])
    text = capsys.readouterr().out
    pipe, want = _reference("card", "ipa", trace="fluctuating", seconds=60, alpha=10.0,
                            beta=0.5, scale_rps=0.1, th=0.5, batches=(1, 2))
    assert f"profiled pipeline SLA_P = {pipe.sla:.2f}s" in text
    summary = next(ln for ln in text.splitlines() if ln.startswith("adaptation summary: "))
    assert ast.literal_eval(summary.split(": ", 1)[1]) == want.summary()
    assert "served batch of 4 through 2 stages -> output tokens (4, 2)" in text


def test_replay_defaults_are_the_launchers():
    """``replay``'s defaults and ``main``'s flags agree with the reference
    launcher's (src/repro/launch/serve.py)."""
    assert serve.replay.__kwdefaults__ == dict(DEFAULTS, policy="ipa", seed=0)
