"""The residual stream's layout between layers, against the reference's.

The reference's ``stack.layer_apply`` constrains the residual stream once
a layer; ``monkeypatch`` records the names it passes to ``constrain``
(``jax.eval_shape``, its blocks unrolled in layer order) with its
``_SEQ_PARALLEL`` switch at its default, off (the port takes that layout
only; ROADMAP, queue 1).  The port runs the same step on a fake 4x2 mesh
(``launch.dryrun.fake_mesh``, meta tensors) and records its own names and
the placements of the residual stream leaving each layer.  ``api.einsum``
on operands sharded by sequence is held in shard-local numbers.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro import configs as RC
from repro.models import model as RM
from repro.models import stack as RST
from repro_torch import configs as TC
from repro_torch.configs.base import InputShape
from repro_torch.distributed import api as dapi
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model as TM
from repro_torch.models import stack as ST
from repro_torch.training.data import input_specs

MESH = MeshShape(("data", "model"), (4, 2))
BATCH = 8
KINDS = ("train", "prefill", "decode")
_JNP = {torch.int32: jnp.int32, torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _ref_names(arch, kind, seq, monkeypatch):
    """The names the reference's ``layer_apply`` passes to ``constrain``,
    layer by layer, its ``_SEQ_PARALLEL`` off."""
    cfg = RC.get_config(arch, reduced=True)
    calls = []
    real = RST.constrain

    def record(x, *names):
        calls.append(names)
        return real(x, *names)

    monkeypatch.setattr(RST, "_SEQ_PARALLEL", False)
    monkeypatch.setattr(RST, "constrain", record)
    params = jax.eval_shape(lambda: RM.init(jax.random.PRNGKey(0), cfg))
    tcfg = TC.get_config(arch, reduced=True)
    batch = {k: jax.ShapeDtypeStruct(tuple(v.shape), _JNP[v.dtype])
             for k, v in input_specs(tcfg, seq, BATCH, kind).items()}
    if kind == "train":
        jax.eval_shape(lambda p, b: RM.forward(p, cfg, b, impl="naive", unroll=True),
                       params, batch)
    elif kind == "prefill":
        jax.eval_shape(lambda p, b: RM.prefill(p, cfg, b, impl="naive", unroll=True),
                       params, batch)
    else:
        prefix = cfg.n_patches if cfg.family == "vlm" else 0
        caches = jax.eval_shape(lambda: RM.init_cache(cfg, BATCH, seq + prefix))
        jax.eval_shape(lambda p, c, t: RM.decode_step(p, cfg, c, seq + prefix - 1, t,
                                                       unroll=True),
                       params, caches, batch["tokens"])
    return calls


def _port_run(arch, kind, seq, monkeypatch):
    """The port's step of ``kind`` (the dry run's: its specs and arguments)
    on a fake 4x2 mesh: the names its
    ``layer_apply`` passes to ``constrain`` and the placements of the
    residual stream leaving each layer."""
    cfg = TC.get_config(arch, reduced=True)
    calls, out = [], []
    real_constrain, real_layer = ST.constrain, ST.layer_apply

    def record(x, *names):
        calls.append(names)
        return real_constrain(x, *names)

    def layer(*args, **kw):
        res = real_layer(*args, **kw)
        out.append(tuple(res[0].placements))
        return res

    monkeypatch.setattr(ST, "constrain", record)
    monkeypatch.setattr(ST, "layer_apply", layer)
    with DR.fake_mesh(MESH) as dm:
        case = DR.build_case(cfg, InputShape("small", seq, BATCH, kind), MESH)
        args = shd.distribute(case.args, dm, case.specs)
        with dapi.use_mesh(dm):
            if kind == "train":     # the forward of the dry run's train step
                TM.forward(args[0], cfg, args[2], impl="naive")
            else:
                case.fn(*args)
    return calls, out


@pytest.fixture(scope="module", autouse=True)
def warm():
    """A first run of each side, which loads jax's tracing and DTensor's
    rules before the timed tests."""
    with pytest.MonkeyPatch.context() as m:
        _ref_names("yi-34b", "train", 32, m)
    with pytest.MonkeyPatch.context() as m:
        _port_run("yi-34b", "train", 32, m)


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
@pytest.mark.parametrize("kind", KINDS)
def test_layout_names_are_the_reference_names(arch, kind, monkeypatch):
    """Layer by layer, the port's ``layer_apply`` asks ``constrain`` for
    what the reference's asks, ("data", None, None) between layers in
    train, prefill and decode, and the residual stream leaves each layer
    with its rows over data and its sequence whole on model."""
    with monkeypatch.context() as m:
        want = _ref_names(arch, kind, 32, m)
    got, out = _port_run(arch, kind, 32, monkeypatch)
    n = TC.get_config(arch, reduced=True).n_layers
    assert len(want) == n and got == want
    assert set(got) == {("data", None, None)}
    assert len(out) == n and set(out) == {(Shard(0), Replicate())}, out


# ---------------------------------------------------------------------------
# api.einsum on operands sharded by sequence, in shard-local numbers
# ---------------------------------------------------------------------------
def _placements_of_einsum(equation, operands, specs, monkeypatch):
    """The placements ``api.einsum`` gives each operand's local shard and
    its result, on the fake 4x2 mesh, operands of ``operands``' shapes
    distributed under ``specs`` on meta."""
    seen = []
    real = dapi._ToLocal.apply

    def to_local(x, pl, grad_pl):
        seen.append(tuple(pl))
        return real(x, pl, grad_pl)

    monkeypatch.setattr(dapi._ToLocal, "apply", to_local)
    with DR.fake_mesh(MESH) as dm:
        metas = [shd.distribute(torch.empty(t.shape, device="meta"), dm, s)
                 for t, s in zip(operands, specs)]
        with dapi.use_mesh(dm):
            out = dapi.einsum(equation, *metas)
    return seen, tuple(out.placements), out.shape


def _by_hand(equation, operands, arg_pl, out_pl, out_shape):
    """``equation`` run rank by rank of the 4x2 mesh on the shards that
    ``arg_pl`` cut, the pieces put together as ``out_pl`` says: a shard in
    its place, a partial sum summed, a replica checked against the first."""
    sizes = MESH.axis_sizes
    out = torch.zeros(out_shape, dtype=torch.float64)
    first = {}

    def cut(t, pl, coord):
        for m, p in enumerate(pl):
            if p.is_shard():
                t = t.chunk(sizes[m], dim=p.dim)[coord[m]]
        return t

    for i in range(sizes[0]):
        for j in range(sizes[1]):
            coord = (i, j)
            local = torch.einsum(equation, *[cut(a, pl, coord)
                                             for a, pl in zip(operands, arg_pl)])
            index = [slice(None)] * len(out_shape)
            for m, p in enumerate(out_pl):
                if p.is_shard():
                    n = out_shape[p.dim] // sizes[m]
                    index[p.dim] = slice(coord[m] * n, (coord[m] + 1) * n)
            key = (tuple((s.start, s.stop) for s in index),
                   tuple(c for c, p in zip(coord, out_pl) if p.is_partial()))
            if any(p.is_replicate() and c for c, p in zip(coord, out_pl)):
                torch.testing.assert_close(local, first[key], rtol=0, atol=0)
                continue
            first[key] = local
            out[tuple(index)] += local
    return out


def test_einsum_attends_over_queries_and_keys_sharded_by_sequence(monkeypatch):
    """Attention's two einsums with q, k and v arriving sharded by sequence
    over model (rows over data): ``api.einsum`` keeps the queries' shards
    and gathers the keys and values (never the diagonal blocks of two
    sequence shards), and the attention put together from each rank's
    numbers is the unsharded one."""
    g = torch.Generator().manual_seed(0)
    b, s, h, d = 8, 6, 2, 4
    q, k, v = (torch.randn(b, s, h, d, generator=g, dtype=torch.float64) for _ in range(3))
    seq = shd.P("data", "model", None, None)
    eq1, eq2 = "bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd"
    arg_pl, out_pl, shape = _placements_of_einsum(eq1, (q, k), (seq, seq), monkeypatch)
    assert arg_pl == [(Shard(0), Shard(1)), (Shard(0), Replicate())]
    assert out_pl == (Shard(0), Shard(2))
    scores = _by_hand(eq1, (q, k), arg_pl, out_pl, shape)
    torch.testing.assert_close(scores, torch.einsum(eq1, q, k), rtol=0, atol=1e-12)
    p = torch.softmax(scores / d ** 0.5, dim=-1)
    arg_pl, out_pl, shape = _placements_of_einsum(
        eq2, (p, v), (shd.P("data", None, "model", None), seq), monkeypatch)
    assert arg_pl == [(Shard(0), Shard(2)), (Shard(0), Replicate())]
    assert out_pl == (Shard(0), Shard(1))
    o = _by_hand(eq2, (p, v), arg_pl, out_pl, shape)
    want = torch.softmax(torch.einsum(eq1, q, k) / d ** 0.5, dim=-1)
    torch.testing.assert_close(o, torch.einsum(eq2, want, v), rtol=0, atol=1e-12)


def test_einsum_sums_keys_sharded_by_sequence_partially(monkeypatch):
    """Probabilities sharded along the keys and values along their
    sequence: the contraction over the keys stays shard-local and the
    output is a partial sum over model, which put together is the
    unsharded product."""
    g = torch.Generator().manual_seed(1)
    p = torch.rand(8, 2, 6, 4, generator=g, dtype=torch.float64)
    v = torch.randn(8, 4, 2, 3, generator=g, dtype=torch.float64)
    eq = "bhqk,bkhd->bqhd"
    arg_pl, out_pl, shape = _placements_of_einsum(
        eq, (p, v), (shd.P("data", None, None, "model"), shd.P("data", "model", None, None)),
        monkeypatch)
    assert arg_pl == [(Shard(0), Shard(3)), (Shard(0), Shard(1))]
    assert out_pl[0] == Shard(0) and out_pl[1].is_partial()
    torch.testing.assert_close(_by_hand(eq, (p, v), arg_pl, out_pl, shape),
                               torch.einsum(eq, p, v), rtol=0, atol=1e-12)
