"""``mfu``'s reading in a throughput cell: the model FLOPs the served batches
needed (each stage's layout's ``batch_flops``) over the summed batch service
time at the H100's bf16 peak, in percent."""
from bench.metrics import mfu as _m

LAYER, UNIT, SOURCE = "model step (models/model.py, stack.py)", "%", "program_span"


def read(ctx):
    return _m.read(ctx)
