"""Requests due in the window that completed within the cell's SLA, over
requests due; a failed request is a miss."""
LAYER, UNIT, SOURCE = "end to end", "share", "host_clock"


def read(ctx):
    recs = ctx.run.recs
    sla = ctx.cell.traffic["sla_s"]
    return sum(r.latency <= sla for r in recs) / len(recs) if recs else None
