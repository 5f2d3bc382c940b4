"""1 - the union of every device operation's interval over the traced
window's wall, in one torch.profiler window."""
LAYER, UNIT, SOURCE = "device", "share", "device_trace"


def read(ctx):
    tr = ctx.trace
    if not tr or tr["window_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
