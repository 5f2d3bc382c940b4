"""The plain reference against the program's plain path at reduced sizes,
and the import rules of the benchmark's code."""
import ast
from pathlib import Path

import pytest
import torch

from bench import harness, spec, weights
from bench.layouts import decoder
from bench.reference import decoder as ref

BENCH = Path(__file__).resolve().parents[1]
CONFIGS = [c["name"] for c in spec.benchmark()["configs"]]


def _port_logits(st, w, tokens, prompt_len):
    """The program's prefill then decode steps on its plain paths, fed the
    same tokens: the logits of the last prompt position and each fed one."""
    from repro_torch.models import model as M
    lay = spec.layout(st)
    cfg = lay.port_config(st, dtype=torch.float32)
    params = lay.to_port(w, st)
    t = tokens.shape[1]
    with torch.inference_mode():
        hl, caches, _ = M.prefill(params, cfg, {"tokens": tokens[:, :prompt_len]},
                                  impl="naive", capacity=t + 1)
        out = [hl @ params["embed"].T]
        for j in range(prompt_len, t):
            lg, caches = M.decode_step(params, cfg, caches, j, tokens[:, j:j + 1], impl="naive")
            out.append(lg)
    return torch.stack(out, 1)


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_matches_the_program_s_plain_path(config):
    prompt_len, fed = 24, 5
    for k, full in enumerate(spec.config(config)["stages"]):
        st = dict(spec.layout(full).tiny(full),
                  num_hidden_layers=min(full["num_hidden_layers"], 8))
        w = weights.make_weights(st, 7, k, "cpu", dtype=torch.float32)
        tokens = torch.randint(0, st["vocab_size"], (3, prompt_len + fed),
                               generator=torch.Generator().manual_seed(k))
        want = _port_logits(st, w, tokens, prompt_len)
        got = spec.reference(st).forward(w, st, [tokens], prompt_len, fed + 1)[0]
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


def test_moe_groups_and_capacity_match_the_program():
    """Routing groups of 4096 tokens and their capacity: (4, 2048) tokens
    are two groups in both."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as MO
    st = decoder.tiny(spec.config("jamba-2p")["stages"][0], d=32)
    st["expert_intermediate_size"] = 16
    w = weights.make_weights(dict(st, num_hidden_layers=2), 3, 0, "cpu", dtype=torch.float32)
    p = "layers.1.moe."
    x = torch.randn(4, 2048, 32, generator=torch.Generator().manual_seed(0))
    got = ref.moe(x, w, p, st, [(0, 2048)], "f32")
    mcfg = MoEConfig(n_experts=st["num_experts"], top_k=2, d_ff_expert=16,
                     capacity_factor=st["capacity_factor"])
    params = {"router": w[p + "router"], "w_gate": w[p + "experts.gate_proj"],
              "w_in": w[p + "experts.up_proj"], "w_out": w[p + "experts.down_proj"]}
    want, _ = MO.moe_apply(params, x, mcfg)
    assert MO.GROUP_SIZE == st["moe_group_size"]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_routing_witness_counts_flips_and_follows_the_program_s_routing():
    """bench/routing.py on a tiny jamba: the program's bf16 routing departs
    from the reference's in some tokens, and the reference fed the
    program's routing lies closer to the served tokens than with its own."""
    from bench import routing
    from bench.tests.tiny import tiny_cell
    got = routing.compare(tiny_cell("jamba-2p.longdoc"), 7, 2, torch.device("cpu"))
    assert len(got["layers"]) == 8
    assert sum(d["prefill_flip"] + d["decode_flip"] for d in got["layers"]) > 0
    assert got["program_routing"]["logit_gap"] < got["own_routing"]["logit_gap"]


@pytest.mark.parametrize("config", CONFIGS)
def test_weights_are_seeded_and_cover_the_program_s_tree(config):
    from repro_torch.models import model as M

    def shapes(tree, pre=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in shapes(v, f"{pre}{k}.").items()}
        if isinstance(tree, list):
            return {k2: v2 for i, v in enumerate(tree) for k2, v2 in shapes(v, f"{pre}{i}.").items()}
        return {pre: (tuple(tree.shape), tree.dtype)}
    for full in spec.config(config)["stages"]:
        lay = spec.layout(full)
        st = lay.tiny(full)
        a = weights.make_weights(st, 2 ** 31 + 5, 0, "cpu")
        b = weights.make_weights(st, 2 ** 31 + 5, 0, "cpu")
        c = weights.make_weights(st, 2 ** 31 + 6, 0, "cpu")
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not torch.equal(a["embed_tokens"], c["embed_tokens"])
        assert weights.n_bytes(st) == sum(t.numel() * t.element_size() for t in a.values())
        theirs = M.init(lay.port_config(st), device="meta")
        assert shapes(lay.to_port(a, st)) == shapes(theirs)


def test_full_width_sizes():
    gib = {c: sum(weights.n_bytes(st) for st in spec.config(c)["stages"]) / 2 ** 30
           for c in ("vlm-classify", "jamba-2p")}
    assert gib["vlm-classify"] == pytest.approx(38.96, abs=0.01)
    assert gib["jamba-2p"] == pytest.approx(47.93, abs=0.01)


def _imports(path: Path, tree=None):
    tree = tree or ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_reference_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, f
    for f in (BENCH / "reference").rglob("*.py"):
        assert not any(m.split(".")[0] == "repro_torch" for m in _imports(f)), f


def test_layouts_import_the_program_only_inside_port_config():
    files = sorted((BENCH / "layouts").glob("*.py"))
    assert BENCH / "layouts" / "decoder.py" in files
    for f in files:
        mod = ast.parse(f.read_text())
        outside = [n for n in mod.body
                   if not (isinstance(n, ast.FunctionDef) and n.name == "port_config")]
        tops = {m.split(".")[0] for n in outside for m in _imports(f, n)}
        assert "repro_torch" not in tops, f


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torchx", types.ModuleType("repro_torchx"))
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert harness.forbidden_modules() == ["repro"]
