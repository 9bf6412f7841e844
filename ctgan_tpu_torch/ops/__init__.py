"""Ops of the ported models (counterpart of ``ctgan_tpu/ops``).

Plain tensor functions: parameters are passed in as tensors, activations are
NCHW, filters OIHW (a transposed conv's ``[in, out, kH, kW]``), linear weights
``[out, in]``.  Convs and linears compute
in the dtype of the precision policy (``core.precision``); norms, pools and
dropout keep their input's dtype.
"""

from .activations import gated_nonlinearity, leaky_relu, log_sum_exp, softplus
from .conv import conv2d, conv_mean_pool2d, deconv2d, mean_pool_conv2d, same_padding
from .dropout import dropout, make_mask
from .linear import linear
from .noise import gaussian_noise
from .norm import batchnorm, cond_batchnorm, cond_layernorm, layernorm
from .pool import global_mean_pool, mean_pool, upsample_nearest
from .weightnorm import applied_weight, l2_dense, wn_conv2d, wn_deconv2d, wn_dense

__all__ = [
    "applied_weight", "batchnorm", "cond_batchnorm", "cond_layernorm", "conv2d", "conv_mean_pool2d", "deconv2d",
    "dropout", "gated_nonlinearity", "gaussian_noise", "global_mean_pool", "l2_dense", "layernorm",
    "leaky_relu", "linear", "log_sum_exp", "make_mask", "mean_pool", "mean_pool_conv2d",
    "same_padding", "softplus", "upsample_nearest", "wn_conv2d", "wn_deconv2d", "wn_dense",
]
