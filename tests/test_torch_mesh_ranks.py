"""The port's meshed train step on several ranks: one gloo process a rank
on this host's CPU, spawned as ``torchrun`` spawns them (rank, world size
and rendezvous in the environment), each test marked slow.

The steps are held against the port's unsharded step in the same process,
so this file needs PyTorch alone; the check that a checkpoint saved on the
mesh reads back through the reference's ``repro.training.checkpoint`` skips
where JAX is not installed.

  PYTHONPATH=src python -m pytest -q -m slow tests/test_torch_mesh_ranks.py
"""
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from repro_torch import configs as TC
from repro_torch.models import convert
from repro_torch.training import checkpoint as TCK
from repro_torch.training import optim as TO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RANK_CODE = r"""
import json, sys
import torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
from repro_torch import configs
from repro_torch.distributed import api as dapi, sharding as shd
from repro_torch.launch import train as LT
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import model as M, moe as MO
from repro_torch.training import checkpoint, data, optim, train as TT

arch, dp, mp, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
dist.init_process_group("gloo")
mesh = make_local_mesh(dp, mp, "cpu")
cfg = configs.get_config(arch, reduced=True)
batch = data.SyntheticStream(cfg, data.DataConfig(seq_len=32, batch_size=8)).batch(0)
step = TT.make_train_step(cfg, optim.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10),
                          impl="naive")
# one routing (ROADMAP R5): the meshed step routes every token to the experts
# the plain step picked, at its own probabilities
picks, top_k = [], MO._top_k
def record(probs, k):
    vals, idx = top_k(probs, k)
    picks.append(idx)
    return vals, idx
def replay(probs, k):
    idx = picks.pop(0)
    probs = probs.redistribute(probs.device_mesh, [Replicate()] * probs.device_mesh.ndim)
    return probs.gather(-1, idx), idx
MO._top_k = record
plain = M.init(cfg, seed=0, device="cpu")
p1, _, m1 = step(plain, optim.init_state(plain), data.to_device(batch, "cpu"))
MO._top_k = replay
meshed = M.init(cfg, seed=0, device="cpu")
meshed = shd.distribute(meshed, mesh, LT.param_specs(meshed, cfg, mesh))
with dapi.use_mesh(mesh):
    p2, s2, m2 = step(meshed, optim.init_state(meshed), data.to_device(batch, "cpu", mesh))
MO._top_k = top_k
full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
leaves = optim.tree_leaves(p2)
rec = {"loss": [float(m1["loss"]), float(full(m2["loss"]))],
       "grad_norm": [float(m1["grad_norm"]), float(full(m2["grad_norm"]))],
       "param_diff": max(float((a - full(b)).abs().max())
                         for a, b in zip(optim.tree_leaves(p1), leaves)),
       "sharded": sum(any(not p.is_replicate() for p in t.placements) for t in leaves),
       "leaves": len(leaves), "unrouted": len(picks), "torch": torch.__version__}
checkpoint.save(out + ".mesh.npz", p2, cfg)
checkpoint.save(out + ".plain.npz", p1, cfg)
if dist.get_rank() == 0:
    json.dump(rec, open(out, "w"))
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(n, argv, timeout=600):
    """``argv`` in ``n`` processes of one gloo group (rank, world size and
    rendezvous in the environment, as torchrun sets them)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), WORLD_SIZE=str(n),
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(argv, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs


MESHES = {"qwen2-moe-a2.7b": (4, 2), "starcoder2-3b": (2, 2)}


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """Each architecture's step on its mesh, run once for the tests below:
    rank 0's record, and the checkpoints of the meshed and the plain step."""
    runs = {}

    def run(arch):
        if arch not in runs:
            dp, mp = MESHES[arch]
            out = str(tmp_path_factory.mktemp(arch) / "rank0.json")
            _run_ranks(dp * mp, [sys.executable, "-c", RANK_CODE, arch, str(dp), str(mp), out])
            runs[arch] = out, json.load(open(out))
        return runs[arch]
    return run


@pytest.mark.slow
@pytest.mark.parametrize("arch", list(MESHES))
def test_meshed_step_on_several_ranks(arch, rank_runs):
    """One reduced f32 step at batch (8, 32) on a dp x mp gloo mesh (the
    reference's own test runs qwen2-moe on 4x2, tests/test_distributed.py),
    against the port's unsharded step in the same process: loss, grad norm
    and every updated parameter within 2e-4, qwen2-moe under one routing;
    the checkpoint saved from the mesh reads back as the plain step's
    parameters."""
    out, rec = rank_runs(arch)
    print(arch, "x".join(map(str, MESHES[arch])), rec)
    assert rec["loss"][1] == pytest.approx(rec["loss"][0], abs=2e-4)
    assert rec["grad_norm"][1] == pytest.approx(rec["grad_norm"][0], rel=2e-4)
    assert rec["param_diff"] <= 2e-4 and rec["unrouted"] == 0 and rec["sharded"] > 0
    cfg = TC.get_config(arch, reduced=True)
    mesh = TCK.load(out + ".mesh.npz", cfg, device="cpu")
    plain = TCK.load(out + ".plain.npz", cfg, device="cpu")
    for a, b in zip(TO.tree_leaves(mesh), TO.tree_leaves(plain)):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=0)


@pytest.mark.slow
@pytest.mark.parametrize("arch", list(MESHES))
def test_mesh_checkpoint_reads_in_the_reference(arch, rank_runs):
    """The checkpoint saved from the mesh reads back through the
    reference's ``checkpoint.load`` (f32, ROADMAP R6) as the plain step's
    parameters."""
    jax = pytest.importorskip("jax")
    import numpy as np
    from repro import configs as RC
    from repro.models import model as RM
    from repro.training import checkpoint as JCK
    out, _ = rank_runs(arch)
    like = jax.eval_shape(lambda: RM.init(jax.random.PRNGKey(0), RC.get_config(arch, reduced=True)))
    cfg = TC.get_config(arch, reduced=True)
    got = convert.params_from_jax(jax.tree.map(np.asarray, JCK.load(out + ".mesh.npz", like)),
                                  cfg, device="cpu")
    plain = TCK.load(out + ".plain.npz", cfg, device="cpu")
    for a, b in zip(TO.tree_leaves(got), TO.tree_leaves(plain)):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=0)


@pytest.mark.slow
def test_torchrun_runs_the_launcher_on_a_2x2_mesh(tmp_path):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch
    starcoder2-3b --reduced --data-par 2 --model-par 2 --steps 3 --device
    cpu`` runs to its end; rank 0 logs every step and saves."""
    path = str(tmp_path / "ckpt.npz")
    argv = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "4",
            "--master-port", str(_free_port()), "-m", "repro_torch.launch.train",
            "--arch", "starcoder2-3b", "--reduced", "--data-par", "2", "--model-par", "2",
            "--steps", "3", "--device", "cpu", "--log-every", "1", "--save", path]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(argv, env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    print(out.stdout)
    assert [line.split()[1] for line in out.stdout.splitlines()
            if line.startswith("step")] == ["0", "1", "2"]
    assert "saved" in out.stdout and os.path.exists(path)
    back = TCK.load(path, TC.get_config("starcoder2-3b", reduced=True), device="cpu")
    assert all(bool(torch.isfinite(t).all()) for t in TO.tree_leaves(back))
