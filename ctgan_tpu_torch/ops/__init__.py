"""Ops of the flagship path (counterpart of ``ctgan_tpu/ops``).

Plain tensor functions: parameters are passed in as tensors, activations are
NCHW, filters OIHW, linear weights ``[out, in]``.
"""

from .conv import conv2d, conv_mean_pool2d, mean_pool_conv2d, same_padding
from .dropout import dropout, make_mask
from .linear import linear
from .norm import batchnorm, cond_batchnorm
from .pool import global_mean_pool, mean_pool, upsample_nearest

__all__ = [
    "batchnorm", "cond_batchnorm", "conv2d", "conv_mean_pool2d", "dropout",
    "global_mean_pool", "linear", "make_mask", "mean_pool", "mean_pool_conv2d",
    "same_padding", "upsample_nearest",
]
