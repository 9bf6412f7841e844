"""Ops of the ported models (counterpart of ``ctgan_tpu/ops``).

Plain tensor functions: parameters are passed in as tensors, activations are
NCHW, filters OIHW (a transposed conv's ``[in, out, kH, kW]``), linear weights
``[out, in]``.  Convs and linears compute
in the dtype of the precision policy (``core.precision``); norms, pools and
dropout keep their input's dtype.
"""

from .activations import gated_nonlinearity, leaky_relu
from .conv import conv2d, conv_mean_pool2d, deconv2d, mean_pool_conv2d, same_padding
from .dropout import dropout, make_mask
from .linear import linear
from .norm import batchnorm, cond_batchnorm, cond_layernorm, layernorm
from .pool import global_mean_pool, mean_pool, upsample_nearest

__all__ = [
    "batchnorm", "cond_batchnorm", "cond_layernorm", "conv2d", "conv_mean_pool2d", "deconv2d",
    "dropout", "gated_nonlinearity", "global_mean_pool", "layernorm", "leaky_relu", "linear",
    "make_mask", "mean_pool", "mean_pool_conv2d", "same_padding", "upsample_nearest",
]
