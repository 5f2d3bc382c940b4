"""The shard-local regions of ``repro_torch.distributed.api`` (``einsum``,
``batchwise``) and a guard against what torch 2.11's DTensor refuses.

The models run their einsums, the Mamba2 conv and scan, the KV cache's
roll and pad and the embedding lookup through these helpers: outside a mesh
they call the function as it is; on a mesh they run it on each rank's
shards, because DTensor in torch 2.11 cannot flatten two sharded dims into
one (an einsum's batch dims), split a sharded dim unevenly, has no rule for
``aten.flip``, ``aten.roll`` or ``index_put`` with sharded indices, and its
``constant_pad_nd`` rule fails on a mesh of two dims.  This release (2.13)
can, so ``Refused211`` reads every DTensor operation of a meshed step and
names those 2.11 would refuse, by 2.11's own rules (its view rules as
``torch.distributed.tensor._ops._view_ops`` states them).

Everything here runs on meta tensors over a ``"fake"`` process group in
this process (``launch.dryrun.fake_mesh``); the values of the meshed steps
are held in ``test_torch_mesh.py``.
"""
import contextlib
import gc

import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._ops._view_ops import Flatten, InputDim, Split, view_groups
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.configs.base import InputShape
from repro_torch.distributed import api as dapi
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun as DR
from repro_torch.launch import train as LT
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model as TM
from repro_torch.training import data as TD
from repro_torch.training import optim as TO
from repro_torch.training import train as TT

MESH = MeshShape(("data", "model"), (4, 2))
aten = torch.ops.aten


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _counter(dm):
    return DR.CollectiveCounter({dm.get_group(i).group_name: n
                                 for i, n in enumerate(dm.mesh_dim_names)})


def test_helpers_call_the_function_off_the_mesh():
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(2, 5, 3, 4, generator=g), torch.randn(2, 7, 3, 4, generator=g)
    assert torch.equal(dapi.einsum("bqhd,bkhd->bhqk", q, k),
                       torch.einsum("bqhd,bkhd->bhqk", q, k))
    table, tokens = torch.randn(10, 4, generator=g), torch.tensor([[1, 9], [3, 3]])
    assert torch.equal(dapi.batchwise(lambda t, e: e[t], (tokens,), (table,)), table[tokens])
    out = dapi.batchwise(lambda x, y: (x + 1, y), (q, None))
    assert torch.equal(out[0], q + 1) and out[1] is None


def test_einsum_keeps_batch_and_heads_on_their_shards():
    """Attention's scores with the batch over data and the heads over
    model: each rank's shards alone, no collective; the probabilities times
    the values likewise."""
    with DR.fake_mesh(MESH) as dm:
        q = shd.distribute(_meta(8, 16, 4, 32), dm, shd.P("data", None, "model", None))
        k = shd.distribute(_meta(8, 24, 4, 32), dm, shd.P("data", None, "model", None))
        counter = _counter(dm)
        with dapi.use_mesh(dm), counter:
            s = dapi.einsum("bqhd,bkhd->bhqk", q, k)
            o = dapi.einsum("bhqk,bkhd->bqhd", s, k)
    assert s.shape == (8, 4, 16, 24) and s.placements == (Shard(0), Shard(1))
    assert s.to_local().shape == (2, 2, 16, 24)
    assert o.shape == (8, 16, 4, 32) and o.placements == (Shard(0), Shard(2))
    assert sum(counter.counts.values()) == 0


def test_einsum_sums_a_sharded_contraction_partially():
    """The MoE combine, experts over model: summed over the local experts,
    the result a partial sum on model; groups stay over data."""
    with DR.fake_mesh(MESH) as dm:
        ye = shd.distribute(_meta(4, 6, 3, 8), dm, shd.P("data", "model", None, None))
        comb = shd.distribute(_meta(4, 5, 6, 3), dm, shd.P("data", None, "model", None))
        with dapi.use_mesh(dm):
            y = dapi.einsum("gecd,gtec->gtd", ye, comb)
    assert y.shape == (4, 5, 8) and y.placements == (Shard(0), Partial())


def test_einsum_replicates_a_label_its_mesh_dim_does_not_divide():
    """Three heads over a model axis of two: the heads are gathered (one
    all-gather an operand) and the scores replicated on model."""
    with DR.fake_mesh(MESH) as dm:
        q = shd.distribute(_meta(8, 16, 3, 32), dm, shd.P("data", None, "model", None))
        counter = _counter(dm)
        with dapi.use_mesh(dm), counter:
            s = dapi.einsum("bqhd,bkhd->bhqk", q, q)
    assert s.placements == (Shard(0), Replicate())
    assert counter.counts["all-gather"] == 2 and counter.by_axis["data"] == 0


def test_batchwise_runs_rows_and_leaves_parameter_gradients_partial():
    """The embedding lookup on each rank's rows: the table gathered whole,
    the rows over data and replicated on model; the table's gradient a
    partial sum over data (the optimizer reduces it onto the table's
    placements) and back on the table's shards on model."""
    with DR.fake_mesh(MESH) as dm:
        table = shd.distribute(_meta(16, 6), dm, shd.P("data", "model")).requires_grad_()
        tokens = shd.distribute(torch.empty(8, 5, dtype=torch.long, device="meta"), dm,
                                shd.P("data", None))
        counter = _counter(dm)
        with dapi.use_mesh(dm), counter:
            x = dapi.batchwise(lambda t, e: e[t], (tokens,), (table,))
            x.sum().backward()
    assert x.shape == (8, 5, 6) and x.placements == (Shard(0), Replicate())
    assert counter.counts["all-gather"] == 2
    assert isinstance(table.grad, DTensor) and table.grad.placements == (Partial(), Shard(1))


def test_batchwise_replicates_rows_the_data_axes_do_not_divide():
    with DR.fake_mesh(MESH) as dm:
        x = shd.distribute(_meta(6, 5), dm, shd.P(None, "model"))
        with dapi.use_mesh(dm):
            y = dapi.batchwise(lambda x: torch.flip(x, (1,)), (x,))
    assert y.shape == (6, 5) and y.placements == (Replicate(), Replicate())


def test_data_partial_grad_reduce_scatters_a_partial_sum_over_data():
    """The identity forward; a gradient that is a partial sum over data,
    where the tensor's rows are sharded, comes back reduce-scattered onto
    those rows (one reduce-scatter over data), and a partial sum over
    model, where the tensor is replicated, stays one: torch 2.11 cannot
    add the first to a gradient sharded over data (ROADMAP P11)."""
    with DR.fake_mesh(MESH) as dm:
        x = shd.distribute(_meta(8, 4, 6), dm, shd.P("data", None, None)).requires_grad_()
        counter = _counter(dm)
        with dapi.use_mesh(dm), counter:
            y = dapi.data_partial_grad(x)
            grads = {}
            for pl in ((Partial(), Shard(2)), (Shard(0), Partial()), (Replicate(), Replicate())):
                g = DTensor.from_local(_meta(8, 4, 3) if pl[1] == Shard(2) else _meta(
                    2 if pl[0] == Shard(0) else 8, 4, 6), dm, pl, run_check=False,
                    shape=(8, 4, 6), stride=(24, 6, 1))
                grads[pl] = torch.autograd.grad(y, x, g, retain_graph=True)[0]
    assert y.placements == x.placements and counter.counts["all-gather"] == 0
    assert grads[(Partial(), Shard(2))].placements == (Shard(0), Shard(2))
    assert grads[(Shard(0), Partial())].placements == (Shard(0), Partial())
    assert grads[(Replicate(), Replicate())].placements == (Replicate(), Replicate())
    assert counter.counts["reduce-scatter"] == 1 and counter.by_axis["model"] == 0
    assert dapi.data_partial_grad(torch.ones(2)).tolist() == [1.0, 1.0]


# ---------------------------------------------------------------------------
# what torch 2.11's DTensor refuses
# ---------------------------------------------------------------------------
_VIEWS = (aten.view.default, aten._unsafe_view.default)


def _refusal(func, args, mesh_sizes):
    """Why torch 2.11's DTensor would refuse ``func`` on ``args``, or None."""
    ts = [a for a in args if isinstance(a, DTensor)]
    if func in (aten.flip.default, aten.roll.default):
        return "no rule"
    if func is aten.constant_pad_nd.default and len(mesh_sizes) > 1:
        return "its rule has one placement for a mesh of two dims"
    if func is aten.index_put.default and any(
            isinstance(i, DTensor) and not all(p.is_replicate() for p in i.placements)
            for i in args[1]):
        return "no rule for sharded indices"
    if func in _VIEWS and ts:
        x = ts[0]
        sharded = {p.dim: i for i, p in enumerate(x.placements) if p.is_shard()}
        for cmd in view_groups(list(x.shape), list(args[1])):
            if isinstance(cmd, Flatten):
                first, *rest = [d.input_dim for d in cmd.input_dims]
                if any(d in sharded for d in rest):
                    return "flattens dims after the first with one sharded"
                if first in sharded and x.shape[first] % mesh_sizes[sharded[first]]:
                    return "flattens an unevenly sharded dim"
            if (isinstance(cmd, Split) and cmd.split_id == 0
                    and isinstance(cmd.input_dim, InputDim)
                    and cmd.input_dim.input_dim in sharded
                    and cmd.group_shape[0] % mesh_sizes[sharded[cmd.input_dim.input_dim]]):
                return "splits a sharded dim unevenly"
    return None


class Refused211(TorchDispatchMode):
    """Records each operation on DTensors that torch 2.11 would refuse."""

    def __init__(self, mesh_sizes):
        super().__init__()
        self.mesh_sizes, self.refused = mesh_sizes, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            why = _refusal(func, args, self.mesh_sizes)
            if why:
                shapes = [(tuple(a.shape), a.placements) for a in args
                          if isinstance(a, DTensor)]
                self.refused.append(f"{func}: {why} {shapes}")
        return func(*args, **(kwargs or {}))


def test_the_guard_knows_the_refusals():
    """The guard names an operation before DTensor runs it; under torch
    2.11 the refused ones then raise."""
    with DR.fake_mesh(MESH) as dm:
        x = shd.distribute(_meta(8, 4, 6), dm, shd.P("data", "model", None))
        guard = Refused211(tuple(MESH.axis_sizes))
        with guard:
            for op in (lambda: x.reshape(32, 6),     # flattens data's and model's dims
                       lambda: x.reshape(8, 24),     # model's dim first: allowed
                       lambda: torch.flip(x, (2,)),
                       lambda: x.view(8, 4, 2, 3)):  # splits no sharded dim
                with contextlib.suppress(RuntimeError, NotImplementedError):
                    op()
    assert [r.split(":")[0] for r in guard.refused] == ["aten.view.default",
                                                        "aten.flip.default"]


STEPS = [(a, k) for a in configs.ARCH_IDS for k in ("decode", "prefill", "grad")
         if not (k == "prefill" and configs.get_config(a).family == "encdec")]


def _launcher_state(cfg, dm):
    """The launcher's parameters on a mesh (FSDP specs) and a batch."""
    params = TM.init(cfg, seed=0, device="meta")
    params = shd.distribute(params, dm, LT.param_specs(params, cfg, dm))
    stream = TD.SyntheticStream(cfg, TD.DataConfig(seq_len=32, batch_size=8))
    return params, TD.to_device(stream.batch(0), "meta", dm)


def _refused_in_step(arch, kind):
    """What torch 2.11 would refuse in one reduced step on a 4x2 mesh: the
    loss and gradients of the launcher's train step (``launch.train`` on a
    mesh: FSDP parameters, naive attention), or the dry run's prefill or
    decode step."""
    cfg = configs.get_config(arch, reduced=True)
    with DR.fake_mesh(MESH) as dm:
        if kind == "grad":
            params, batch = _launcher_state(cfg, dm)
            leaves = TO.tree_leaves(params)

            def step():
                for p in leaves:
                    p.requires_grad_(True)
                loss, _ = TT.loss_fn(params, cfg, batch, impl="naive")
                torch.autograd.grad(loss, leaves)
        else:
            case = DR.build_case(cfg, InputShape("small", 32, 8, kind), MESH)
            args = shd.distribute(case.args, dm, case.specs)

            def step():
                case.fn(*args)
        guard = Refused211(tuple(MESH.axis_sizes))
        with dapi.use_mesh(dm), guard:
            step()
    return guard.refused


@pytest.fixture(scope="module")
def warm():
    """A first meshed step, which loads DTensor's rules and PyTorch's meta
    kernels before the steps below."""
    _refused_in_step("starcoder2-3b", "grad")


@pytest.fixture
def collected():
    """Each step's object graph collected after it, not during the next."""
    yield
    gc.collect()


@pytest.mark.parametrize("arch,kind", STEPS)
def test_meshed_steps_ask_nothing_torch_2_11_refuses(arch, kind, warm, collected):
    """Each reduced architecture's training gradients, prefill and decode
    step on a 4x2 mesh ask DTensor for nothing torch 2.11 refuses."""
    refused = _refused_in_step(arch, kind)
    assert not refused, refused[:5]


def test_the_optimizer_step_asks_nothing_torch_2_11_refuses(warm):
    """AdamW on reduced qwen2-moe's meshed parameters (FSDP, 3-D expert
    weights) with gradients as the batch leaves them: partial sums over
    data where the parameter is replicated there."""
    cfg = configs.get_config("qwen2-moe-a2.7b", reduced=True)
    with DR.fake_mesh(MESH) as dm:
        params, _ = _launcher_state(cfg, dm)
        grads = TO.tree_map(lambda p: DTensor.from_local(
            torch.zeros_like(p.to_local()), dm,
            [Partial() if q.is_replicate() and i == 0 else q for i, q in enumerate(p.placements)],
            run_check=False, shape=p.shape, stride=p.stride()), params)
        guard = Refused211(tuple(MESH.axis_sizes))
        with dapi.use_mesh(dm), guard:
            TO.apply_updates(params, grads, TO.init_state(params), TO.AdamWConfig(total_steps=10))
    assert not guard.refused, guard.refused[:5]
