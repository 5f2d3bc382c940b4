"""K1 (kernels/flash_attention.py) at latent attention's prefill (q/k head
dim 192, v 128): its calls' least time over its kernels' device time."""
from bench.metrics import _kernel_share as _m

LAYER, UNIT, SOURCE = "kernels (kernels/*.py, csrc/*.cu)", "%", "device_trace"
NAMES = ("flash_tc_kernel", "flash_kernel",)


def read(ctx):
    return _m.share(ctx, "mla_prefill", NAMES)
