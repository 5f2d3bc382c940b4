"""The yardstick's counts against hand counts at one shape each, and every
cell's counts from its stages' layouts."""
import pytest

from bench import harness, spec
from bench import roofline as R
from bench.layouts import decoder as D

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def test_flash_bound_hand_count():
    # B 2, S 4, causal: pairs 1+2+3+4 = 10 a (batch, head); H 4, KV 2, hd 64
    ms, binds = R.flash_bound(2, 4, 4, 4, 2, 64, "bf16")
    flops = 4.0 * 2 * 4 * 64 * 10
    nbytes = (2 * 2 * 4 * 4 * 64 + 2 * 2 * 4 * 2 * 64) * 2
    assert binds == "bytes"
    assert ms == pytest.approx(max(flops / 989e12, nbytes / 3.35e12) * 1e3)


def test_flash_bound_window_and_long_prompt_binds_operations():
    # window 2: keys per query 1, 2, 2, 2 -> 7 pairs
    ms, _ = R.flash_bound(1, 4, 4, 1, 1, 64, "bf16", window=2)
    assert ms == pytest.approx(max(4.0 * 64 * 7 / 989e12, (2 * 4 * 64 + 2 * 4 * 64) * 2 / 3.35e12) * 1e3)
    assert R.flash_bound(4, 2048, 2048, 32, 8, 128, "bf16")[1] == "operations"


def test_decode_bound_hand_count():
    ms, binds = R.decode_bound(8, 2, 128, 16, [9, 9, 9], "bf16")
    slots = 27
    nbytes = (2 * 3 * 8 * 128 + 2 * 2 * 128 * slots) * 2 + 4 * 3
    assert binds == "bytes"
    assert ms == pytest.approx(max(4.0 * 8 * 128 * slots / 989e12, nbytes / 3.35e12) * 1e3)


def test_ssd_bound_hand_count():
    # B 1, S 3, chunk 2: chunks of 2 and 1 rows -> pairs 3 and 1
    b, s, h, p, g, n = 1, 3, 2, 4, 1, 8
    flops = (2 * 3 * n * g + h * (2 * 3 * p + 4 * 2 * p * n)) + (2 * 1 * n * g + h * (2 * 1 * p + 4 * 1 * p * n))
    nbytes = 2 * s * h * p * 2 + 4 * s * h + 4 * h + 2 * s * g * n * 2 + 4 * h * p * n
    ms, binds = R.ssd_bound(b, s, h, p, g, n, 2, "bf16")
    assert ms == pytest.approx(max(flops / 989e12, nbytes / 3.35e12) * 1e3)
    assert binds == "bytes"


def _dense_stage():
    return {"layout": "decoder", "family": "dense", "num_hidden_layers": 1, "hidden_size": 8, "num_attention_heads": 2,
            "num_key_value_heads": 1, "head_dim": 4, "intermediate_size": 16, "vocab_size": 10}


def test_batch_flops_dense_gqa_by_hand():
    st = _dense_stage()
    # a token at context k: q 8x8, k and v 8x4 each, o 8x8, scores+PV 4*2*4*k, mlp 3x8x16
    per = lambda k: 2 * 8 * 8 + 2 * 2 * 8 * 4 + 2 * 8 * 8 + 4 * 2 * 4 * k + 6 * 8 * 16  # noqa: E731
    head = 2 * 8 * 10
    # prompt 3, gen 2: prompt positions keys 1..3, logits once, one decode token at keys 4
    want = 2 * (per(1) + per(2) + per(3) + head + per(4) + head)
    assert D.batch_flops(st, 2, 3, 2) == pytest.approx(want)


def test_layer_flops_mamba2_and_moe_by_hand():
    st = D.tiny(spec.config("jamba-2p")["stages"][0], d=64)
    st["num_experts"] = 4
    d, m = 64, D.mamba_dims(st)
    assert (m["d_inner"], m["gn"], m["heads"], m["conv_dim"]) == (128, 16, 4, 160)
    mamba = 2 * d * (2 * 128 + 2 * 16 + 4) + 2 * 128 * d + 2 * 160 * 4 + 4 * 4 * 32 * 16
    moe = 2 * d * 4 + 2 * 6 * d * 64       # router, top-2 of 4 experts of width 64
    # layer 1: Mamba2 + MoE; layer 0: Mamba2 + dense MLP of width 128
    assert D._layer_flops(st, 1, 5) == pytest.approx(mamba + moe)
    assert D._layer_flops(st, 0, 5) == pytest.approx(mamba + 6 * d * 128)


def test_kernel_bounds_count_every_call():
    st = _dense_stage()
    st["num_hidden_layers"] = 3
    got = D.kernel_bounds(st, 2, 8, 3)
    assert got["attn_prefill"] == pytest.approx(3 * R.flash_bound(2, 8, 8, 2, 1, 4, "bf16")[0])
    dec = sum(R.decode_bound(2, 1, 4, 11, [9 + j] * 2, "bf16")[0] for j in range(3))
    assert got["attn_decode"] == pytest.approx(3 * dec)
    assert got["ssd"] == 0.0


@pytest.mark.parametrize("name", CELLS)
def test_every_roofline_a_cell_reports_has_calls_to_count(name):
    """Each stage's layout counts FLOPs in proportion to the rows, and every
    ``<role>_roofline`` metric that lists the cell finds calls of its role
    in some stage (a share over no bound would read 0)."""
    cell = harness.load_cell(name)
    b = cell.traffic["batch_size"]
    bound = {}
    for st, (prompt, gen) in zip(cell.stages, cell.lengths()):
        lay = spec.layout(st)
        assert lay.batch_flops(st, b, prompt, gen) == pytest.approx(
            b * lay.batch_flops(st, 1, prompt, gen))
        for role, ms in lay.kernel_bounds(st, b, prompt, gen).items():
            bound[role] = bound.get(role, 0.0) + ms
    roles = [m["name"][:-len("_roofline")] for m in harness.cell_metrics(name, "per_layer")
             if m["name"].endswith("_roofline")]
    for role in roles:
        assert bound.get(role, 0.0) > 0, role
