"""A kernel role's roofline share: the summed least time of every call the
served batches made (each stage's layout's ``kernel_bounds``, from shapes
by bench/roofline.py's bounds; 0 in a stage that makes no call of the
role) over the device time of the kernels whose names the role's metric
lists, in percent.  None where the trace holds no such kernel."""
from bench import spec


def share(ctx, role, names):
    tr = ctx.trace
    if not tr:
        return None
    dev_s = sum(t for k, t in tr["kernels"].items() if any(n in k for n in names))
    if dev_s <= 0:
        return None
    bound_ms = 0.0
    for b in ctx.run.batches:
        for st, (prompt, gen) in zip(ctx.cell.stages, ctx.lengths):
            bound_ms += spec.layout(st).kernel_bounds(st, len(b.rids), prompt, gen).get(role, 0.0)
    return 100.0 * bound_ms * 1e-3 / dev_s
