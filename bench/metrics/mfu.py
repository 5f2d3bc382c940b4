"""The model FLOPs the served batches needed (each stage's layout's
``batch_flops``, from the configuration and each batch's size and lengths;
bench/roofline.py says what is counted) over the summed batch service time
at the H100's bf16 peak, in percent."""
from bench import roofline, spec

LAYER, UNIT, SOURCE = "model step (models/model.py, stack.py)", "%", "program_span"


def read(ctx):
    flops, secs = 0.0, 0.0
    for b in ctx.run.batches:
        if not b.stage_lats:
            continue
        for st, (prompt, gen), lat in zip(ctx.cell.stages, ctx.lengths, b.stage_lats):
            flops += spec.layout(st).batch_flops(st, len(b.rids), prompt, gen)
            secs += lat
    return 100.0 * flops / (secs * roofline.PEAK_FLOPS["bf16"]) if secs else None
