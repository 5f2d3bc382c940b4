"""Plain PyTorch oracles of the kernels, under the names of
``repro/kernels/ref.py``.  The attention oracles live beside their kernels;
``ssd_scan_ref`` is the naive O(S) recurrence of ``models/ssm.py``.  This
module re-exports them."""
from repro_torch.kernels.decode_attention import (  # noqa: F401
    decode_attention_plain as decode_attention_ref)
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention_plain as flash_attention_ref)
from repro_torch.models.ssm import ssd_reference as ssd_scan_ref  # noqa: F401
