"""Mean of PipelineEngine.serve's summed stage latencies a batch."""


def mean_ms(ctx):
    lats = [sum(b.stage_lats) for b in ctx.run.batches if b.stage_lats]
    return 1e3 * sum(lats) / len(lats) if lats else None
