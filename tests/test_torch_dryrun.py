"""The port's dry run (``repro_torch.launch.dryrun``, a probe on meta
tensors) against the reference's ``repro.launch.dryrun``.

The reference sets ``XLA_FLAGS`` to 512 host devices when it is imported,
so it runs only in a subprocess (``JAX_PLATFORMS=cpu``), once for the
module, which prints its numbers as JSON: for every dry-run pair on both
production meshes ``model_flops_per_device``, ``serving_fsdp``,
``_weights`` and ``_probe_cfg``'s depths (held bit for bit); the flops of
its ``probe_costs`` (XLA's ``cost_analysis``) on a 1x1 mesh for reduced
dense, MoE, SSM and enc-dec configs at a small shape of each kind; and the
per-device ``argument_size_in_bytes`` of its compiled prefill and decode
steps of two reduced configs on a 4x2 mesh (held exactly).  Beside it, in a
second subprocess, the port's CLI sweeps every pair at full width.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.base import InputShape
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import stack as ST

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOPS_ARCHS = ("yi-34b", "qwen2-moe-a2.7b", "mamba2-2.7b", "whisper-medium")
BYTES_ARCHS = ("yi-34b", "qwen2-moe-a2.7b")
KINDS = ("train", "prefill", "decode")
WEIGHTS_MODES = ("auto", "tp", "fsdp", "expert2d", "expertff")
# FlopCounterMode counts the products only; XLA's cost analysis also counts
# elementwise operations (norms, softmax, RoPE, the SSD scan's exps: 2 to 6%
# of the total at these reduced widths), and its simplifier may drop some of
# the products an eager program runs (the port counts 2% more at qwen2-moe's
# train step).  Held within 10%.
FLOPS_RTOL = 0.1
HLO_KEYS = ("hlo_flops_per_dev", "hlo_bytes_per_dev", "lower_s", "compile_s")

REF_CODE = r"""
import json
from repro.launch import dryrun as DR
import jax
from repro import configs
from repro.configs.base import InputShape
from repro.distributed import api as dapi
from repro.distributed import sharding as shd

class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)

out = {"pairs": {}, "flops": {}, "args": {}}
for mp in (False, True):
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16} if mp else {"data": 16, "model": 16})
    for arch, shape in configs.all_dryrun_pairs():
        cfg = configs.get_config(arch)
        out["pairs"][f"{arch}|{shape.name}|{int(mp)}"] = {
            "model_flops": DR.model_flops_per_device(cfg, shape, 512 if mp else 256),
            "serving_fsdp": DR.serving_fsdp(cfg, mesh),
            "weights": {m: list(DR._weights(cfg, mesh, m)) for m in WEIGHTS_MODES},
            "probe": {k: [DR._probe_cfg(cfg, k).n_layers, DR._probe_cfg(cfg, k).n_encoder_layers]
                      for k in (1, 2)}}
mesh1 = DR.make_custom_mesh("1x1")
for arch in FLOPS_ARCHS:
    cfg = configs.get_config(arch, reduced=True)
    for kind in KINDS:
        pc = DR.probe_costs(cfg, InputShape("small_" + kind, 64, 4, kind), mesh1)
        out["flops"][f"{arch}|{kind}"] = [pc["flops"], pc["probe_raw"][1]["flops"],
                                         pc["probe_raw"][2]["flops"]]
mesh8 = DR.make_custom_mesh("4x2")
for arch in BYTES_ARCHS:
    cfg = configs.get_config(arch, reduced=True)
    for kind in ("prefill", "decode"):
        dapi.set_axis_rules(shd.axis_rules(mesh8))
        fn, args, in_sh, out_sh, donate = DR.build_case(
            cfg, InputShape("small_" + kind, 64, 8, kind), mesh8)
        with jax.set_mesh(mesh8):
            compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                               donate_argnums=donate).lower(*args).compile()
        dapi.set_axis_rules(None)
        out["args"][f"{arch}|{kind}"] = compiled.memory_analysis().argument_size_in_bytes
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's numbers and the port's ``--all`` sweep, each in its
    own process, run side by side."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    src = os.path.join(REPO, "src")
    header = (f"FLOPS_ARCHS = {FLOPS_ARCHS!r}\nBYTES_ARCHS = {BYTES_ARCHS!r}\n"
              f"KINDS = {KINDS!r}\nWEIGHTS_MODES = {WEIGHTS_MODES!r}\n")
    ref = subprocess.Popen([sys.executable, "-c", header + REF_CODE], cwd=REPO,
                           env=dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu"),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    sweep = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                              "--out", str(out)], cwd=REPO,
                             env=dict(os.environ, PYTHONPATH=src),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # meanwhile, a first count here loads PyTorch's meta kernels
        DR.count(DR.build_case(configs.get_config("yi-34b", reduced=True),
                               InputShape("warm", 64, 4, "train"), MeshShape(("data",), (1,))))
        ref_out, ref_err = ref.communicate(timeout=600)
        sweep_out, sweep_err = sweep.communicate(timeout=1200)
    finally:
        for p in (ref, sweep):
            p.kill()
    assert ref.returncode == 0, ref_err[-3000:]
    records = {}
    for name in os.listdir(out):
        rec = json.load(open(out / name))
        records[(rec["arch"], rec["shape"])] = rec
    return {"ref": json.loads(ref_out.splitlines()[-1]), "sweep_rc": sweep.returncode,
            "sweep_out": sweep_out, "sweep_err": sweep_err, "records": records}


def _fake(mesh):
    return MeshShape(tuple(mesh), tuple(mesh.values()))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_serving_rules_model_flops_and_probe_depths_equal_the_reference(arch, runs):
    for mp in (False, True):
        mesh = _fake({"pod": 2, "data": 16, "model": 16} if mp else {"data": 16, "model": 16})
        cfg = configs.get_config(arch)
        for shape in configs.shapes_for_arch(arch):
            ref = runs["ref"]["pairs"][f"{arch}|{shape.name}|{int(mp)}"]
            assert DR.model_flops_per_device(cfg, shape, mesh.size) == ref["model_flops"]
            assert DR.serving_fsdp(cfg, mesh) == ref["serving_fsdp"]
            assert {m: list(DR._weights(cfg, mesh, m)) for m in WEIGHTS_MODES} == ref["weights"]
            assert {str(k): [DR._probe_cfg(cfg, k).n_layers, DR._probe_cfg(cfg, k).n_encoder_layers]
                    for k in (1, 2)} == ref["probe"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FLOPS_ARCHS)
def test_counted_flops_near_xla_cost_analysis(arch, kind, runs):
    total, one, two = runs["ref"]["flops"][f"{arch}|{kind}"]
    pc = DR.probe_costs(configs.get_config(arch, reduced=True),
                        InputShape("small_" + kind, 64, 4, kind),
                        MeshShape(("data", "model"), (1, 1)))
    for got, want in ((pc["flops"], total), (pc["probe_raw"][1]["flops"], one),
                      (pc["probe_raw"][2]["flops"], two)):
        assert abs(got / want - 1) <= FLOPS_RTOL, (got, want)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", BYTES_ARCHS)
def test_argument_bytes_equal_the_compiled_reference(arch, kind, runs):
    """Per device on a 4x2 mesh: parameters under the serving specs, the
    batch (and for decode the caches and the int32 position) under theirs."""
    mesh = MeshShape(("data", "model"), (4, 2))
    case = DR.build_case(configs.get_config(arch, reduced=True),
                         InputShape("small_" + kind, 64, 8, kind), mesh)
    assert DR.sharded_bytes(case.arg_shapes, case.arg_specs, mesh) == \
        runs["ref"]["args"][f"{arch}|{kind}"]


def test_cli_sweep_every_case_ok(runs):
    """``python -m repro_torch.launch.dryrun --all``: every pair of
    ``configs.all_dryrun_pairs`` at full width on the 16x16 mesh."""
    assert runs["sweep_rc"] == 0, runs["sweep_err"][-3000:]
    assert "dry-run complete: 35/35 ok" in runs["sweep_out"]
    assert set(runs["records"]) == {(a, s.name) for a, s in configs.all_dryrun_pairs()}


@pytest.mark.parametrize("arch,shape", [(a, s.name) for a, s in configs.all_dryrun_pairs()])
def test_sweep_record(arch, shape, runs):
    rec = runs["records"][(arch, shape)]
    assert rec["ok"], rec.get("error")
    assert rec["mesh"] == "data=16xmodel=16" and rec["devices"] == 256
    assert not set(HLO_KEYS) & set(rec)
    # collectives by kind, from DTensor on a fake 16x16 mesh; both axes
    # leave an 8-card node, so every byte goes over the NIC figure
    coll = rec["collectives"]
    assert set(coll) == {*DR.KINDS, "_counts", "_by_axis"}
    assert rec["collective_bytes_per_dev"] == sum(coll[k] for k in DR.KINDS) > 0
    assert sum(coll["_by_axis"].values()) == rec["collective_bytes_per_dev"]
    assert rec["link_bw"] == {"data": DR.NIC_BW, "model": DR.NIC_BW}
    assert rec["collective_s"] == pytest.approx(rec["collective_bytes_per_dev"] / DR.NIC_BW)
    assert coll["collective-permute"] == 0 and rec["links"] == DR.LINKS
    assert rec["collective_note"] == DR.COLLECTIVE_NOTE
    assert rec["mem"]["temp_gb"] is None and rec["mem"]["argument_gb"] > 0
    flops, nbytes = rec["counted_flops_per_dev"], rec["counted_bytes_per_dev"]
    assert flops >= rec["model_flops_per_dev"] > 0
    assert rec["compute_s"] == flops / 989e12 and rec["counted_memory_s"] == nbytes / 3.35e12
    # the eager count's terms do not take the compiled program's names
    assert not {"memory_s", "bottleneck"} & set(rec)
    terms = {"compute": rec["compute_s"], "memory": rec["counted_memory_s"],
             "collective": rec["collective_s"]}
    assert rec["counted_bottleneck"] == max(terms, key=terms.get)
    assert rec["useful_flops_ratio"] == rec["model_flops_per_dev"] / flops


# one reduced config of each family; the SSD scan's Python loop over 4096-
# and 32768-token prompts is run at full width by the sweep above
REDUCED_CASES = [(a, "decode_32k") for a in ("yi-34b", "phi-3-vision-4.2b", "qwen2-moe-a2.7b",
                                               "mamba2-2.7b", "jamba-v0.1-52b", "whisper-medium")]
REDUCED_CASES += [(a, "train_4k") for a in ("yi-34b", "qwen2-moe-a2.7b", "whisper-medium")]
REDUCED_CASES += [("yi-34b", "prefill_32k"), ("jamba-v0.1-52b", "long_500k")]


@pytest.mark.parametrize("arch,shape", REDUCED_CASES)
def test_run_case_on_a_reduced_config(arch, shape):
    rec = DR.run_case(arch, shape, cfg=configs.get_config(arch, reduced=True), verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["params"] == configs.get_config(arch, reduced=True).n_params()
    assert rec["counted_flops_per_dev"] > 0 and rec["counted_bytes_per_dev"] > 0
    assert rec["mem"]["output_gb"] > 0
    assert rec["probe"]["n_rep"] == ST.decoder_plan(configs.get_config(arch, reduced=True)).n_rep


def test_microbatches_count_the_same_products():
    cfg = configs.get_config("yi-34b", reduced=True)
    one, two = (DR.run_case("yi-34b", "train_4k", cfg=cfg, microbatch=m, verbose=False)
                for m in (1, 2))
    assert one["ok"] and two["ok"]
    assert two["counted_flops_per_dev"] == one["counted_flops_per_dev"]
    assert two["mem"] == one["mem"]


def test_a_failing_case_is_recorded_and_fails_the_sweep(tmp_path, monkeypatch):
    rec = DR.run_case("yi-34b", "decode_32k", weights_mode="bogus", verbose=False)
    assert not rec["ok"] and rec["error"] == "ValueError: bogus" and "traceback" in rec
    monkeypatch.setattr(DR, "run_case", lambda *a, **k: dict(rec, total_s=0.0))
    assert DR.main(["--arch", "yi-34b", "--shape", "decode_32k", "--out", str(tmp_path)]) == 1
    assert json.load(open(tmp_path / "yi-34b__decode_32k__singlepod__einsum.json"))["ok"] is False


def test_the_counters_on_one_product():
    """FlopCounterMode: 2 m n k; the byte counter: each operand and the
    result once, views (the transpose) nothing."""
    a = torch.empty((64, 32), dtype=torch.bfloat16, device="meta")
    b = torch.empty((48, 32), dtype=torch.bfloat16, device="meta")
    flops, nbytes = FlopCounterMode(display=False), DR.ByteCounter()
    with flops, nbytes:
        a @ b.T
    assert flops.get_total_flops() == 2 * 64 * 48 * 32
    assert nbytes.bytes == (64 * 32 + 48 * 32 + 64 * 48) * 2


def test_sharded_bytes_divide_by_the_sharding_axes():
    mesh = MeshShape(("pod", "data", "model"), (2, 4, 8))
    meta = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")  # noqa: E731
    shapes = {"w": meta(64, 16), "b": (meta(8), meta(3))}
    specs = {"w": shd.P(("pod", "data"), "model"), "b": (shd.P("model"), shd.P(None))}
    assert DR.sharded_bytes(shapes, specs, mesh) == 64 * 16 * 4 // 64 + 8 * 4 // 8 + 3 * 4
