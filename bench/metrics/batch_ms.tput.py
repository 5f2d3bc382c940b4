"""The engine's service time a batch: the mean of PipelineEngine.serve's
summed stage latencies (host clock after a synchronize)."""
from bench.metrics import _batch_ms as _m

LAYER, UNIT, SOURCE = "engine (serving/engine.py)", "ms", "program_span"


def read(ctx):
    return _m.mean_ms(ctx)
