"""Tiny copies of the benchmark's cells for CPU tests: the cell's own
traffic and limits, with each stage cut by its layout's ``tiny``."""
import copy

from bench import harness, spec


def tiny_cell(name: str, **traffic) -> harness.Cell:
    c = harness.load_cell(name)
    cfg = copy.deepcopy(c.config)
    cfg["stages"] = [spec.layout(st).tiny(st) for st in cfg["stages"]]
    tr = dict(copy.deepcopy(c.traffic), prompt_tokens=32, check_tokens=64,
              warm_batches=c.traffic["warm_batches"][:1])
    if tr["loop"] == "open":
        tr["rate_rps"] = 40.0
    tr.update(traffic)
    return harness.Cell(name, cfg, tr)
