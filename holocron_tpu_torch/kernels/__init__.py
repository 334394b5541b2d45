"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

Importing this package builds nothing; each kernel is built by ``nvcc`` on first use
(:mod:`._build`). ``KERNELS`` maps each kernel's name to its launch counter.
"""

from . import int8_conv, involution

KERNELS = {"involution": involution.KERNEL, "int8_conv": int8_conv.KERNEL}

__all__ = ["KERNELS", "int8_conv", "involution"]
