"""Mean size of the batches CentralQueue formed, over its batch size."""
LAYER, UNIT, SOURCE = "batching (serving/batching.py)", "share", "program_counter"


def read(ctx):
    b = ctx.run.batches
    return sum(len(x.rids) for x in b) / len(b) / ctx.cell.traffic["batch_size"] if b else None
