"""Sharded execution in the port (``repro_torch.distributed``,
``launch.mesh``, ``launch.train`` on a mesh, the dry run's collective
count) against the reference's ``repro.distributed`` and its train step.

Placements are held shard shape for shard shape against
``NamedSharding(AbstractMesh(...), spec).shard_shape`` of the reference's
specs, on ``DeviceMesh``es over a process group of backend ``"fake"`` in
this process (``launch.dryrun.fake_mesh``), at full width on meta tensors.
The reference's specs are of its stacked layout: a block leaf's shard
carries a leading layer axis, which the port's per-layer leaves do not
have, and where FSDP put ``data`` on that axis the port replicates the
per-layer leaf over ``data`` (ROADMAP P10; ``test_p10_...`` states what it
costs).  The train step runs on a gloo group of one rank in this process;
tests that need several ranks are in ``test_torch_mesh_ranks.py``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro import configs as RC
from repro.distributed import api as rapi
from repro.distributed import sharding as RS
from repro.models import model as RM
from repro.training import optim as JO
from repro.training import train as JT
from repro_torch import configs as TC
from repro_torch.configs.base import InputShape
from repro_torch.distributed import api as dapi
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun as DR
from repro_torch.launch import train as LT
from repro_torch.launch.mesh import MeshShape, make_local_mesh, make_production_mesh
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import stack as ST
from repro_torch.training import checkpoint as TCK
from repro_torch.training import data as TD
from repro_torch.training import optim as TO
from repro_torch.training import train as TT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"4x2": MeshShape(("data", "model"), (4, 2)), "16x16": make_production_mesh()}


class FakeMesh:
    """Just enough Mesh interface for the reference's spec rules."""

    def __init__(self, mesh: MeshShape):
        self.shape = mesh.shape
        self.axis_names = mesh.axis_names


def _abstract(mesh: MeshShape):
    return AbstractMesh(tuple(mesh.axis_sizes), tuple(mesh.axis_names))


def _ref_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {RS._path_str(p): x for p, x in flat}


def _port_flat(tree):
    out = {}
    shd.map_with_path(lambda p, x: out.__setitem__(p, x), tree)
    return out


def _local_meta(tree):
    """Each DTensor's local shard as a meta tensor of its shape."""
    return TO.tree_map(lambda t: torch.empty(t.to_local().shape, dtype=t.dtype, device="meta"),
                       tree)


@pytest.fixture(scope="module")
def ref_params():
    """The reference's stacked parameter shapes of every architecture."""
    return {a: jax.eval_shape(lambda a=a: RM.init(jax.random.PRNGKey(0), RC.get_config(a)))
            for a in RC.ARCH_IDS}


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------
def _p10(ref_spec, path):
    return "/blocks/" in path and ref_spec[0] is not None


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_param_shards_are_the_reference_shards(arch, mesh, ref_params):
    """Under the training specs (fsdp=True) every leaf's local shard has
    the reference's shard shape; a block leaf's without its layer axis,
    which the port holds whole (n_rep layers a device) where the reference
    shards it (P10)."""
    ms, cfg = MESHES[mesh], TC.get_config(arch)
    ref_specs = _ref_flat(RS.param_specs(ref_params[arch], FakeMesh(ms), fsdp=True))
    ref_shapes = _ref_flat(ref_params[arch])
    params = TM.init(cfg, device="meta")
    with DR.fake_mesh(ms) as dm:
        local = _port_flat(convert.param_shapes(
            _local_meta(shd.distribute(params, dm, LT.param_specs(params, cfg, dm))), cfg))
    n_rep = ST.decoder_plan(cfg).n_rep
    assert set(local) == set(ref_specs)
    for path, spec in ref_specs.items():
        want = NamedSharding(_abstract(ms), spec).shard_shape(ref_shapes[path].shape)
        got = tuple(local[path].shape)
        if "/blocks/" in path:
            assert got[1:] == want[1:], path
            assert got[0] == (want[0] * ms.shape[spec[0]] if _p10(spec, path) else want[0])
            assert "enc_stack" in path or got[0] == n_rep
        else:
            assert got == want, path


# P10: per-device bytes of the train step's parameters (fsdp=True) that
# the port holds beyond the reference's, as the dry run's ``sharded_bytes``
# counts them; every other (architecture, mesh) pair holds the same bytes.
# On 16x16 FSDP puts data on the layer axis of mamba2's stacked SSM vectors,
# conv_w and norm; on 4x2 also jamba's, and the rules take qwen2-moe's
# stacked shared-expert weights (n_rep, d, ff) for an expert dim and put
# model on their layer axis (24 layers over 2).
P10_EXTRA = {("mamba2-2.7b", "16x16"): 243600, ("mamba2-2.7b", "4x2"): 1559040,
             ("jamba-v0.1-52b", "4x2"): 1051680, ("qwen2-moe-a2.7b", "4x2"): 207618048}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_p10_costs_the_layer_shards_of_the_stacked_leaves(arch, mesh):
    """What the port's per-layer leaves add to a device: for each stacked
    leaf whose layer axis the rules shard, its bytes less the reference's
    shards of them."""
    ms, cfg = MESHES[mesh], TC.get_config(arch)
    params = TM.init(cfg, device="meta")
    stacked = convert.param_shapes(params, cfg)
    ref = shd.param_specs(stacked, ms, fsdp=True)
    ref_bytes = DR.sharded_bytes(stacked, ref, ms)
    port_bytes = DR.sharded_bytes(params, LT.param_specs(params, cfg, ms), ms)
    extra, leaves = 0, _port_flat(stacked)
    for path, spec in _port_flat_specs(ref).items():
        if _p10(spec, path):
            leaf = leaves[path]
            per = leaf.numel() * leaf.element_size()
            div = int(np.prod([ms.shape[a] for a in _axes(spec[1:])]))
            extra += per // div - per // div // ms.shape[spec[0]]
    assert port_bytes - ref_bytes == extra == P10_EXTRA.get((arch, mesh), 0)


def _axes(entries):
    return [a for e in entries for a in ((e,) if isinstance(e, str) else e or ())]


def _port_flat_specs(tree):
    out = {}

    def walk(t, path):
        if isinstance(t, shd.PartitionSpec):
            out[path] = t
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}" if path else k)
        else:
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}" if path else str(i))
    walk(tree, "")
    return out


CACHE_CASES = [("gemma3-27b", "long_500k"), ("yi-34b", "decode_32k"),
               ("kimi-k2-1t-a32b", "decode_32k"), ("mamba2-2.7b", "decode_32k"),
               ("jamba-v0.1-52b", "long_500k"), ("whisper-medium", "decode_32k")]


@pytest.mark.parametrize("arch,shape", CACHE_CASES)
def test_cache_and_batch_shards_are_the_reference_shards(arch, shape):
    """The decode caches the dry run builds and the input batch, on the
    16x16 mesh; at batch 1 (long_500k) the KV cache's seq dim is
    context-parallel over data.  A block cache's layer axis is held whole
    (P10)."""
    ms = make_production_mesh()
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    s = TC.INPUT_SHAPES[shape]
    cap = s.seq_len + (tcfg.n_patches if tcfg.family == "vlm" else 0)
    ref_shapes = jax.eval_shape(lambda: RM.init_cache(rcfg, s.global_batch, cap))
    ref_specs = _ref_flat(RS.cache_specs(rcfg, RC.INPUT_SHAPES[shape], FakeMesh(ms), ref_shapes))
    caches = TM.init_cache(tcfg, s.global_batch, cap, device="meta")
    specs = convert.cache_specs_from_jax(
        shd.cache_specs(tcfg, s, ms, convert.cache_shapes(caches, tcfg)), tcfg)
    tokens = torch.empty((s.global_batch, s.seq_len), dtype=torch.int32, device="meta")
    tspec = shd.batch_specs(tcfg, s, ms)("tokens", tokens.shape)
    with DR.fake_mesh(ms) as dm:
        local = _port_flat(convert.cache_shapes(_local_meta(shd.distribute(caches, dm, specs)),
                                                tcfg))
        tok = shd.distribute(tokens, dm, tspec).to_local().shape
    n_rep = ST.decoder_plan(tcfg).n_rep
    for path, spec in ref_specs.items():
        want = NamedSharding(_abstract(ms), spec).shard_shape(_ref_flat(ref_shapes)[path].shape)
        got = tuple(local[path].shape)
        if path.startswith("blocks/"):
            # the KV rule takes a Mamba2 conv cache (its path ends in "v")
            # and puts the batch's axis on its layer axis: P10 again
            assert got[1:] == want[1:] and got[0] == n_rep, path
            assert want[0] == n_rep or (path.endswith("conv") and spec[0] is not None)
        else:
            assert got == want, path
    rspec = RS.batch_specs(rcfg, RC.INPUT_SHAPES[shape], FakeMesh(ms))("tokens", tokens.shape)
    assert tuple(tok) == NamedSharding(_abstract(ms), rspec).shard_shape(tuple(tokens.shape))
    if shape == "long_500k" and tcfg.family != "ssm":
        assert any(spec[-3] == "data" for p, spec in ref_specs.items() if p.endswith("k"))


def test_named_maps_entries_to_mesh_dims():
    ms = MeshShape(("pod", "data", "model"), (2, 2, 2))
    with DR.fake_mesh(ms) as dm:
        assert shd.named(dm, {"a": shd.P(("pod", "data"), None, "model"), "b": [shd.P()]}) == {
            "a": (Shard(0), Shard(0), Shard(2)), "b": [(Replicate(),) * 3]}
        x = shd.distribute(torch.empty(8, 3, 6, device="meta"), dm,
                           shd.P(("pod", "data"), None, "model"))
        assert x.to_local().shape == (2, 3, 3)
        for bad in (shd.P(("data", "pod")), shd.P("data", "data"), shd.P("rows")):
            with pytest.raises(ValueError):
                shd.placements(dm, bad)


# ---------------------------------------------------------------------------
# constrain
# ---------------------------------------------------------------------------
def _ref_constrain_spec(mesh: MeshShape, shape, names):
    """The spec the reference's ``constrain`` pins, read from its jaxpr
    under an abstract mesh; None where it returns its input unpinned."""
    rapi.set_axis_rules(RS.axis_rules(FakeMesh(mesh)))
    try:
        with jax.sharding.use_abstract_mesh(_abstract(mesh)):
            jaxpr = jax.make_jaxpr(lambda a: rapi.constrain(a, *names))(jnp.zeros(shape))
    finally:
        rapi.set_axis_rules(None)
    eqns = [e for e in jaxpr.eqns if e.primitive.name == "sharding_constraint"]
    return tuple(eqns[0].params["sharding"].spec) if eqns else None


CONSTRAINTS = [((8, 3, 6), ("data", None, "model")),
               ((8, 3, 5), ("data", None, "model")),       # 5: model (2) dropped
               ((6, 4), ("data", "model")),                # 6: data (4) dropped
               ((8, 4, 2, 6), ("data", None, "model", None)),
               ((8, 4), ("data", None, None))]             # rank mismatch: skipped


@pytest.mark.parametrize("shape,names", CONSTRAINTS)
def test_constrain_pins_what_the_reference_pins(shape, names):
    ms = MESHES["4x2"]
    want = _ref_constrain_spec(ms, shape, names)
    x = torch.ones(shape)
    assert dapi.constrain(x, *names) is x                  # outside a mesh
    with DR.fake_mesh(ms) as dm:
        d = shd.distribute(torch.empty(shape, device="meta"), dm, shd.P())
        with dapi.use_mesh(dm):
            assert dapi.mesh_axis_size("data") == 4 and dapi.mesh_axis_size("model") == 2
            assert dapi.constrain(x, *names) is x          # a plain tensor
            got = dapi.constrain(d, *names)
        assert dapi.mesh_axis_size("data") == 1 and dapi.get_axis_rules() is None
        if want is None:
            assert got is d
        else:
            assert got.placements == shd.placements(dm, shd.P(*want))


def test_whole_pieces_gathers_a_dim_the_view_cannot_split():
    ms = MESHES["4x2"]
    with DR.fake_mesh(ms) as dm:
        x = shd.distribute(torch.empty(8, 3 * 16, device="meta"), dm, shd.P(None, "model"))
        assert dapi.whole_pieces(x, -1, 4).placements == x.placements   # 4 heads over 2
        y = dapi.whole_pieces(x, -1, 3)                     # 3 heads over 2: gathered
        assert y.placements == (Replicate(), Replicate())
        assert y.view(8, 3, 16).shape == (8, 3, 16)
    t = torch.ones(2, 6)
    assert dapi.whole_pieces(t, -1, 3) is t


# ---------------------------------------------------------------------------
# the train step on a mesh of one rank
# ---------------------------------------------------------------------------
@pytest.fixture
def gloo_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_local_mesh(1, 1, "cpu")
    finally:
        dist.destroy_process_group()


def test_local_mesh_is_a_device_mesh_of_the_group(gloo_one):
    assert tuple(gloo_one.mesh_dim_names) == ("data", "model")
    assert tuple(gloo_one.shape) == (1, 1) and gloo_one.device_type == "cpu"
    with pytest.raises(RuntimeError, match="a 2x2 mesh needs 4 ranks"):
        make_local_mesh(2, 2, "cpu")


STEP_ARCHS = ("starcoder2-3b", "qwen2-moe-a2.7b")


@pytest.fixture(scope="module")
def ref_steps():
    """One reference train step (impl="naive") of each reduced f32
    architecture on a batch of 4 x 32, beside its params and batch."""
    out = {}
    for arch in STEP_ARCHS:
        cfg = RC.get_config(arch, reduced=True)
        params = RM.init(jax.random.PRNGKey(0), cfg)
        batch = TD.SyntheticStream(TC.get_config(arch, reduced=True),
                                   TD.DataConfig(seq_len=32, batch_size=4)).batch(0)
        step = jax.jit(JT.make_train_step(cfg, JO.AdamWConfig(total_steps=10), impl="naive"))
        new, _, m = step(params, JO.init_state(params),
                         {k: jnp.asarray(v) for k, v in batch.items()})
        out[arch] = dict(params=jax.tree.map(np.asarray, params), batch=batch,
                         new=jax.tree.map(np.asarray, new), loss=float(m["loss"]),
                         gnorm=float(m["grad_norm"]))
    return out


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


LAUNCH_ARGV = ["--arch", "starcoder2-3b", "--reduced", "--steps", "2", "--device", "cpu",
               "--log-every", "1", "--batch", "2", "--seq", "16"]


@pytest.fixture(scope="module")
def gloo_runs(ref_steps, tmp_path_factory):
    """On a gloo group of one rank in this process: each reduced step with
    the reference's converted weights without a mesh and through the mesh
    path (all leaves gathered back), a checkpoint saved from the mesh and
    loaded onto it, and the launcher on the initialised group; then, with
    the group gone, the launcher's plain path."""
    out = {}
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_local_mesh(1, 1, "cpu")
        for arch in STEP_ARCHS:
            r, cfg = ref_steps[arch], TC.get_config(arch, reduced=True)
            step = TT.make_train_step(cfg, TO.AdamWConfig(total_steps=10), impl="naive")
            plain = convert.params_from_jax(r["params"], cfg, device="cpu")
            p1, s1, m1 = step(plain, TO.init_state(plain), TD.to_device(r["batch"], "cpu"))
            meshed = convert.params_from_jax(r["params"], cfg, device="cpu")
            meshed = shd.distribute(meshed, mesh, LT.param_specs(meshed, cfg, mesh))
            with dapi.use_mesh(mesh):
                p2, s2, m2 = step(meshed, TO.init_state(meshed),
                                  TD.to_device(r["batch"], "cpu", mesh))
            dtensors = all(isinstance(t, DTensor)
                           for t in TO.tree_leaves(p2) + TO.tree_leaves(s2["mu"]))
            out[arch] = dict(plain=(p1, s1, m1), dtensors=dtensors,
                             meshed=(TO.tree_map(_full, p2), TO.tree_map(_full, s2),
                                     {k: _full(v) for k, v in m2.items()}))
        cfg = TC.get_config("starcoder2-3b", reduced=True)
        params = TM.init(cfg, seed=1, device="cpu")
        specs = LT.param_specs(params, cfg, mesh)
        path = str(tmp_path_factory.mktemp("mesh") / "m.npz")
        TCK.save(path, shd.distribute(params, mesh, specs), cfg)
        back = TCK.load(path, cfg, device="cpu", mesh=mesh, specs=specs)
        out["checkpoint"] = (params, back)
        lp, _, out["launch_meshed"] = LT.main(LAUNCH_ARGV)
        out["launch_dtensors"] = isinstance(TO.tree_leaves(lp)[0], DTensor)
        out["group_kept"] = dist.is_initialized()
    finally:
        dist.destroy_process_group()
    _, _, out["launch_plain"] = LT.main(LAUNCH_ARGV)
    return out


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_meshed_step_is_the_unmeshed_step_and_the_reference(gloo_runs, ref_steps, arch):
    """A reduced f32 step through the launcher's mesh path on a gloo mesh of
    one rank: within 1e-6 of the step without a mesh, within 2e-4 of the
    reference's on the same converted weights."""
    r, cfg = ref_steps[arch], TC.get_config(arch, reduced=True)
    run = gloo_runs[arch]
    (p1, s1, m1), (p2, s2, m2) = run["plain"], run["meshed"]
    assert run["dtensors"]
    for k in ("loss", "grad_norm", "ce", "aux"):
        assert float(m2[k]) == pytest.approx(float(m1[k]), abs=1e-6)
    for a, b in zip(TO.tree_leaves(p1) + TO.tree_leaves(s1["nu"]),
                    TO.tree_leaves(p2) + TO.tree_leaves(s2["nu"])):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=0)
    assert float(m1["loss"]) == pytest.approx(r["loss"], abs=2e-4)
    assert float(m1["grad_norm"]) == pytest.approx(r["gnorm"], rel=2e-4)
    want = convert.params_from_jax(r["new"], cfg, device="cpu")
    for a, b in zip(TO.tree_leaves(want), TO.tree_leaves(p2)):
        torch.testing.assert_close(b, a, atol=2e-4, rtol=0)


def test_checkpoint_round_trip_on_a_mesh(gloo_runs):
    params, back = gloo_runs["checkpoint"]
    for a, b in zip(TO.tree_leaves(params), TO.tree_leaves(back)):
        assert isinstance(b, DTensor) and torch.equal(b.full_tensor(), a)


def test_launcher_trains_on_an_initialised_group(gloo_runs):
    """A process group of one rank already there: the launcher takes the
    mesh path, leaves the caller's group, and its losses are the plain
    path's."""
    assert gloo_runs["launch_dtensors"] and gloo_runs["group_kept"]
    meshed, plain = gloo_runs["launch_meshed"], gloo_runs["launch_plain"]
    assert [h["step"] for h in meshed] == [h["step"] for h in plain] == [0, 1]
    for a, b in zip(meshed, plain):
        assert a["loss"] == pytest.approx(b["loss"], abs=1e-6)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-6)


# ---------------------------------------------------------------------------
# the dry run's collective count
# ---------------------------------------------------------------------------
def test_collectives_of_one_dense_layer_by_hand():
    """One dense (MLP) layer in the serving layout on a fake 4x2 mesh: the
    rows of x over data, w_in and w_gate by columns and w_out by rows over
    model.  The products stay local; w_out's output is a partial sum over
    model, and the layer's ``constrain(x, "data", None, None)`` reduces it:
    one all-reduce of x's local rows, (B / 4) x S x d f32, over model."""
    b, s, d, ff = 8, 16, 64, 256
    ms = MESHES["4x2"]
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    params = {"w_in": meta(d, ff), "w_gate": meta(d, ff), "w_out": meta(ff, d)}
    specs = {k: shd.param_specs({"stack": {"0": {"mlp": {k: v}}}}, ms)["stack"]["0"]["mlp"][k]
             for k, v in params.items()}
    assert specs == {"w_in": (None, "model"), "w_gate": (None, "model"),
                     "w_out": ("model", None)}
    with DR.fake_mesh(ms) as dm:
        groups = {dm.get_group(i).group_name: n for i, n in enumerate(dm.mesh_dim_names)}
        p = shd.distribute(params, dm, specs)
        x = shd.distribute(meta(b, s, d), dm, shd.P("data", None, None))
        counter = DR.CollectiveCounter(groups)
        with dapi.use_mesh(dm), counter:
            y = dapi.constrain(x + TL.mlp(p, x), "data", None, None)
    assert y.placements == (Shard(0), Replicate())
    assert counter.bytes == {"all-reduce": (b // 4) * s * d * 4, "all-gather": 0,
                             "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}
    assert counter.counts["all-reduce"] == 1
    assert counter.by_axis == {"data": 0, "model": (b // 4) * s * d * 4}


@torch.library.custom_op("repro_torch_mesh_test::twice", mutates_args=())
def _twice(x: torch.Tensor) -> torch.Tensor:
    """An operation DTensor has no sharding rule for."""
    return x * 2


@_twice.register_fake
def _(x):
    return torch.empty_like(x)


def test_an_operation_without_a_rule_fails_the_count():
    """The count runs nothing on gathered operands: an operation DTensor
    refuses fails it, and the case's record says so (``ok`` false)."""
    ms = MESHES["4x2"]
    with DR.fake_mesh(ms) as dm:
        groups = {dm.get_group(i).group_name: n for i, n in enumerate(dm.mesh_dim_names)}
        x = shd.distribute(torch.empty(8, 6, device="meta"), dm, shd.P("data", None))
        counter = DR.CollectiveCounter(groups)
        with pytest.raises(NotImplementedError, match="twice"), counter:
            torch.ops.repro_torch_mesh_test.twice(x)
    assert counter.counts == dict.fromkeys(DR.KINDS, 0)


def test_link_figures_by_axis():
    """Ranks in mesh order, 8 a node: on 16x16 both axes leave a node (the
    model axis spans 16 consecutive ranks, data strides 16), on 4x2 none."""
    for ms, want in ((MESHES["16x16"], {"data": DR.NIC_BW, "model": DR.NIC_BW}),
                     (MESHES["4x2"], {"data": DR.NVLINK_BW, "model": DR.NVLINK_BW}),
                     (MeshShape(("data", "model"), (2, 4)),
                      {"data": DR.NVLINK_BW, "model": DR.NVLINK_BW}),
                     (MeshShape(("data", "model"), (4, 4)),
                      {"data": DR.NIC_BW, "model": DR.NVLINK_BW})):
        with DR.fake_mesh(ms) as dm:
            assert DR.link_bw(dm) == want


@pytest.fixture(scope="module")
def decode_collectives():
    cfg = TC.get_config("yi-34b", reduced=True)
    return cfg, DR.probe_collectives(cfg, InputShape("small_decode", 64, 8, "decode"),
                                     MESHES["4x2"])


def test_probe_collectives_extrapolate_as_the_flops(decode_collectives):
    cfg, got = decode_collectives
    n_rep, raw = ST.decoder_plan(cfg).n_rep, got["probe_raw"]
    for kind, v in got["bytes"].items():
        assert v == max(raw[1]["bytes"][kind]
                        + (n_rep - 1) * (raw[2]["bytes"][kind] - raw[1]["bytes"][kind]), 0)
    assert sum(got["bytes"].values()) == sum(got["by_axis"].values()) > 0
    assert got["seconds"] == pytest.approx(sum(got["by_axis"].values()) / DR.NVLINK_BW)


def test_fake_mesh_refuses_an_initialised_group(gloo_one):
    with pytest.raises(RuntimeError, match="destroy the initialised one"):
        with DR.fake_mesh(MESHES["4x2"]):
            pass


@pytest.fixture(scope="module")
def port_imports():
    code = ("import sys, repro_torch, repro_torch.launch.dryrun, repro_torch.launch.train, "
            "repro_torch.distributed.api, repro_torch.training.checkpoint\n"
            "assert not [m for m in sys.modules if m.startswith("
            "'torch.testing._internal.distributed')], sys.modules\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)


def test_the_port_imports_no_fake_process_group(port_imports):
    """``torch.testing._internal.distributed`` (the fake process group) is
    imported by the dry run's collective count only, when it runs."""
    assert port_imports.returncode == 0, port_imports.stderr[-2000:]
