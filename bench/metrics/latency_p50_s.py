"""The 50th percentile of the latency of every request due in the window,
from its due time to its last stage's tokens on the host."""
from bench.metrics import _latency as _lat

LAYER, UNIT, SOURCE = "end to end", "s", "host_clock"


def read(ctx):
    return _lat.percentile(ctx, 0.50)
