"""PyTorch/CUDA port of the IPA reproduction in ``repro`` (JAX/Pallas).

The port is a package of its own: it imports ``torch`` and never ``jax`` or
``repro``.  Its entry points run on the CUDA card unless the caller passes
``device="cpu"``; its attention kernels are CUDA C++ for Hopper under
``kernels/csrc``, built at first use.
"""
