"""K3 (kernels/ssd_scan.py): its calls' least time over its kernels' device time."""
from bench.metrics import _kernel_share as _m

LAYER, UNIT, SOURCE = "kernels (kernels/*.py, csrc/*.cu)", "%", "device_trace"
NAMES = ("ssd_",)


def read(ctx):
    return _m.share(ctx, "ssd", NAMES)
