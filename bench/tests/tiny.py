"""Tiny copies of the benchmark's cells for CPU tests: the cell's own
traffic and limits, with the configurations' widths and depths cut."""
import copy

from bench import harness


def tiny_stage(st: dict, d: int = 0) -> dict:
    """Width 256 and 4096 ids; dense stages keep 4 layers, the hybrid its
    16 (both periods) with 8 experts.  So cut, the fp8 control still reads
    above each cell's limit on every seed tried."""
    hybrid = st["family"] == "hybrid"
    d = d or 256
    st = copy.deepcopy(st)
    st.update(hidden_size=d, num_attention_heads=4, head_dim=32, intermediate_size=2 * d,
              vocab_size=4096)
    st["num_key_value_heads"] = 2 if st["num_key_value_heads"] < st["num_attention_heads"] else 4
    if hybrid:
        st.update(num_experts=8, expert_intermediate_size=d, mamba_head_dim=32,
                  mamba_chunk_size=16)
    else:
        st["num_hidden_layers"] = 4
    return st


def tiny_cell(name: str, **traffic) -> harness.Cell:
    c = harness.load_cell(name)
    cfg = copy.deepcopy(c.config)
    cfg["stages"] = [tiny_stage(st) for st in cfg["stages"]]
    tr = dict(copy.deepcopy(c.traffic), prompt_tokens=32, check_tokens=64,
              warm_batches=c.traffic["warm_batches"][:1])
    if tr["loop"] == "open":
        tr["rate_rps"] = 40.0
    tr.update(traffic)
    return harness.Cell(name, cfg, tr)
