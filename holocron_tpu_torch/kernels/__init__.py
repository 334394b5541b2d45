"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

Importing this package builds nothing; each kernel is built by ``nvcc`` on first use
(:mod:`._build`). ``KERNELS`` maps each kernel's name to its launch counter.
"""

from . import add2d, int8_conv, involution

KERNELS = {
    "involution": involution.KERNEL,
    "involution_general": involution.KERNEL_GENERAL,
    "involution_bwd_dxp": involution.KERNEL_DXP,
    "involution_bwd_dkern": involution.KERNEL_DKERN,
    "involution_bwd_dxp_general": involution.KERNEL_DXP_GENERAL,
    "involution_bwd_dkern_general": involution.KERNEL_DKERN_GENERAL,
    "add2d_fwd": add2d.KERNEL_FWD,
    "add2d_bwd_dp": add2d.KERNEL_BWD_DP,
    "add2d_bwd_dw": add2d.KERNEL_BWD_DW,
    "int8_conv": int8_conv.KERNEL,
    "int8_conv_halo": int8_conv.KERNEL_HALO,
    "int8_pointwise": int8_conv.KERNEL_POINTWISE,
    "int8_conv_general": int8_conv.KERNEL_GENERAL,
    "int8_quantize": int8_conv.KERNEL_QUANTIZE,
}

__all__ = ["KERNELS", "add2d", "int8_conv", "involution"]
