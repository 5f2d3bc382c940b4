"""K2 (kernels/decode_attention.py): its calls' least time over its kernels' device time."""
from bench.metrics import _kernel_share as _m

LAYER, UNIT, SOURCE = "kernels (kernels/*.py, csrc/*.cu)", "%", "device_trace"
NAMES = ("decode_split",)


def read(ctx):
    return _m.share(ctx, "attn_decode", NAMES)
