"""Requests completed in the window over the window's seconds, the window
ending at the last completion."""
LAYER, UNIT, SOURCE = "end to end", "requests/s", "host_clock"


def read(ctx):
    run = ctx.run
    done = sum(not r.failed for r in run.recs)
    span = run.t_end - run.t0
    return done / span if span > 0 else None
