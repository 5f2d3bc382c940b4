"""The port's sharding rules and mesh shapes against the reference's
``repro.distributed`` and ``repro.launch.mesh``, spec for spec.

The reference computes specs on its stacked parameter and cache trees
(``jax.eval_shape`` of its ``init`` / ``init_cache``); the port on the same
layout, restacked from its own meta-tensor init by
``convert.param_shapes`` / ``cache_shapes``.  Specs are compared by path
string, as tuples (the port's ``PartitionSpec`` is a tuple).  The meshes are
``FakeMesh``es, as in tests/test_distributed.py.
"""
import hashlib

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as RC
from repro.distributed import api as rapi
from repro.distributed import sharding as RS
from repro.models import model as RM
from repro_torch import configs as TC
from repro_torch.distributed import api as tapi
from repro_torch.distributed import sharding as TS
from repro_torch.launch import mesh as TMESH
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.models import stack as ST
from repro_torch.training import optim


class FakeMesh:
    """Just enough Mesh interface for spec-rule tests."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.axis_sizes = tuple(shape.values())


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
EXPERT_MODES = ("none", "hidden_data", "hidden_model")
DECODE_SHAPES = [s for s in RC.INPUT_SHAPES.values() if s.kind == "decode"]


@pytest.fixture(scope="module")
def ref_params():
    """The reference's stacked parameter shapes of every architecture (and
    the port's first meta init, which loads PyTorch's meta kernels)."""
    TM.init(TC.get_config("yi-34b", reduced=True), device="meta")
    return {a: jax.eval_shape(lambda a=a: RM.init(jax.random.PRNGKey(0), RC.get_config(a)))
            for a in RC.ARCH_IDS}


def _ref_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {RS._path_str(p): x for p, x in flat}


def _port_flat(tree):
    out = {}
    TS.map_with_path(lambda p, x: out.__setitem__(p, x), tree)
    return out


def _port_spec_flat(tree):
    out = {}

    def walk(t, path):
        if isinstance(t, TS.PartitionSpec):
            out[path] = tuple(t)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}" if path else k)
        else:
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}" if path else str(i))
    walk(tree, "")
    return out


def _same_shapes(ref_tree, port_tree):
    ref = {p: (tuple(x.shape), str(x.dtype)) for p, x in _ref_flat(ref_tree).items()}
    port = {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in _port_flat(port_tree).items()}
    assert port == ref


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_meta_init_restacks_to_the_reference_shapes(arch, ref_params):
    """``model.init`` on meta at full width (kimi-k2's 1T included), through
    the shape-only restack: the reference's tree, shapes and types."""
    cfg = TC.get_config(arch)
    params = TM.init(cfg, device="meta")
    assert all(t.device.type == "meta" for t in optim.tree_leaves(params))
    _same_shapes(ref_params[arch], convert.param_shapes(params, cfg))


# sha256 of the bytes of every leaf of the reduced yi-34b, whisper-medium and
# jamba inits at seed 3 on the CPU, as the port drew them before ``init``
# learned the meta device: building on meta must not move the CPU draws
CPU_INIT_DIGEST = "5297701b2d8748bfdc3055a4dbb3ade21c3b4b365a90e27082ee41186cddefeb"


def test_cpu_init_draws_as_before():
    h = hashlib.sha256()
    for arch in ("yi-34b", "whisper-medium", "jamba-v0.1-52b"):
        cfg = TC.get_config(arch, reduced=True)
        params = TM.init(cfg, seed=3, device="cpu")
        meta = TM.init(cfg, seed=3, device="meta")
        for t, m in zip(optim.tree_leaves(params), optim.tree_leaves(meta)):
            assert (t.shape, t.dtype) == (m.shape, m.dtype)
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == CPU_INIT_DIGEST


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh, ref_params):
    cfg = TC.get_config(arch)
    port_shapes = convert.param_shapes(TM.init(cfg, device="meta"), cfg)
    fm = FakeMesh(MESHES[mesh])
    modes = EXPERT_MODES if cfg.moe is not None else ("none",)
    for fsdp in (False, True):
        for em in modes:
            ref = {p: tuple(s) for p, s in _ref_flat(RS.param_specs(
                ref_params[arch], fm, fsdp=fsdp, expert_mode=em)).items()}
            port = _port_spec_flat(TS.param_specs(port_shapes, fm, fsdp=fsdp, expert_mode=em))
            assert port == ref, (fsdp, em)


@pytest.mark.parametrize("shape", [s.name for s in DECODE_SHAPES])
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, shape):
    """At every decode shape, with the cache the dry run builds (capacity
    seq_len + the VLM prefix); batch 1 at long_500k context-parallels the
    KV sequence over data."""
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    s = RC.INPUT_SHAPES[shape]
    cap = s.seq_len + (rcfg.n_patches if rcfg.family == "vlm" else 0)
    ref_shapes = jax.eval_shape(lambda: RM.init_cache(rcfg, s.global_batch, cap))
    port_shapes = convert.cache_shapes(TM.init_cache(tcfg, s.global_batch, cap, device="meta"),
                                       tcfg)
    _same_shapes(ref_shapes, port_shapes)
    for mesh in MESHES.values():
        fm = FakeMesh(mesh)
        ref = {p: tuple(x) for p, x in _ref_flat(RS.cache_specs(rcfg, s, fm, ref_shapes)).items()}
        port = _port_spec_flat(TS.cache_specs(tcfg, TC.INPUT_SHAPES[shape], fm, port_shapes))
        assert port == ref
    if shape == "long_500k" and any(spec.is_attn for spec in ST.layer_specs(tcfg)):
        assert any(sp[-3] == ("pod", "data") for p, sp in port.items() if p.endswith("k"))


@pytest.mark.parametrize("mesh", list(MESHES) + ["data-only", "model-only"])
def test_batch_specs_and_axis_rules_equal_the_reference(mesh):
    shape = {"data-only": {"data": 4}, "model-only": {"model": 8}}.get(mesh) or MESHES[mesh]
    fm = FakeMesh(shape)
    assert TS.axis_rules(fm) == RS.axis_rules(fm)
    for s in RC.INPUT_SHAPES.values():
        cfg = RC.get_config("yi-34b")
        ref, port = RS.batch_specs(cfg, s, fm), TS.batch_specs(TC.get_config("yi-34b"),
                                                               TC.INPUT_SHAPES[s.name], fm)
        for name, arr in (("tokens", (s.global_batch, s.seq_len)),
                          ("frames", (s.global_batch, 7, 3))):
            assert tuple(port(name, arr)) == tuple(ref(name, arr))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_resolve_equals_the_reference_under_set_rules(mesh):
    fm = FakeMesh(MESHES[mesh])
    names = [("data", None, "model"), ("model",), (None, None), ("data", "data"),
             ("unknown", "model"), ()]
    try:
        for rules in (RS.axis_rules(fm), {"data": (), "model": ("model",)}, None):
            rapi.set_axis_rules(rules)
            tapi.set_axis_rules(rules)
            assert tapi.get_axis_rules() == rapi.get_axis_rules()
            for n in names:
                assert tuple(tapi.resolve(n)) == tuple(rapi.resolve(n)), (rules, n)
            # outside a mesh the reference's constrain is the identity too
            x = torch.ones(2, 3)
            assert tapi.constrain(x, "data", "model") is x
            assert tapi.mesh_axis_size("data") == rapi.mesh_axis_size("data") == 1
    finally:
        rapi.set_axis_rules(None)
        tapi.set_axis_rules(None)


def test_production_meshes():
    one, two = TMESH.make_production_mesh(), TMESH.make_production_mesh(multi_pod=True)
    assert (one.shape, one.axis_names, one.size) == ({"data": 16, "model": 16},
                                                     ("data", "model"), 256)
    assert (two.shape, two.axis_names, two.size) == ({"pod": 2, "data": 16, "model": 16},
                                                     ("pod", "data", "model"), 512)
    assert list(two.shape) == ["pod", "data", "model"]
    assert TS.MeshAxes.of(two) == TS.MeshAxes(("pod", "data"), ("model",))
    with pytest.raises(ValueError):
        TMESH.MeshShape(("data",), (1, 2))


def test_local_mesh_needs_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        TMESH.make_local_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert TMESH.make_local_mesh(2, 1).shape == {"data": 2, "model": 1}
    with pytest.raises(RuntimeError, match="a 2x2 mesh needs 4"):
        TMESH.make_local_mesh(2, 2)
