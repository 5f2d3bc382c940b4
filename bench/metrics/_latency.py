"""Latency percentiles by nearest rank over every request due in the
window, a failed request counting as infinitely late."""
import math


def percentile(ctx, q):
    lat = sorted(r.latency for r in ctx.run.recs)
    if not lat:
        return None
    return lat[max(math.ceil(q * len(lat)) - 1, 0)]
