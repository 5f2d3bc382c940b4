"""Plain PyTorch oracles of the kernels, under the names of
``repro/kernels/ref.py``.  They live beside their kernels; this module
re-exports them."""
from repro_torch.kernels.decode_attention import (  # noqa: F401
    decode_attention_plain as decode_attention_ref)
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention_plain as flash_attention_ref)
