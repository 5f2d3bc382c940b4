"""Set-up: process start to the first due arrival (weights, libraries,
warm-up of the cell's batch sizes)."""
LAYER, UNIT, SOURCE = "end to end", "s", "host_clock"


def read(ctx):
    return ctx.setup_s
