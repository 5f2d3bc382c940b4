"""Mean wait in the batching queue: a request's due time to the pop_batch
that took it (harness stamps)."""
LAYER, UNIT, SOURCE = "batching (serving/batching.py)", "ms", "program_span"


def read(ctx):
    w = [r.popped - r.due for r in ctx.run.recs if r.popped == r.popped]
    return 1e3 * sum(w) / len(w) if w else None
