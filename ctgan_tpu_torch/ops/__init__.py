"""Ops of the ported models (counterpart of ``ctgan_tpu/ops``).

Plain tensor functions: parameters are passed in as tensors (the recurrent
cells and the MLP take a dict of them and the layer's name), activations are
NCHW, filters OIHW (a transposed conv's ``[in, out, kH, kW]``), linear weights
``[out, in]``.  Convs and linears compute
in the dtype of the precision policy (``core.precision``); norms, pools and
dropout keep their input's dtype.
"""

from .activations import centered_softplus, gated_nonlinearity, leaky_relu, log_sum_exp, softplus
from .conv import (
    conv1d,
    conv2d,
    conv_mean_pool2d,
    deconv2d,
    mean_pool_conv2d,
    same_padding,
    separable_conv2d,
    upsample_conv2d,
)
from .dropout import dropout, make_mask
from .embedding import embedding
from .linear import linear
from .lsuv import lsuv_init
from .minibatch import minibatch_discrimination
from .mlp import mlp
from .noise import gaussian_noise
from .norm import batchnorm, cond_batchnorm, cond_layernorm, layernorm
from .pool import depth_to_space, global_mean_pool, mean_pool, space_to_depth, upsample_nearest
from .recurrent import gru, gru_step, rnn, rnn_step
from .stats import kl_gaussian_gaussian, kl_unit_gaussian
from .weightnorm import applied_weight, l2_dense, wn_conv2d, wn_deconv2d, wn_dense

__all__ = [
    "applied_weight", "batchnorm", "centered_softplus", "cond_batchnorm", "cond_layernorm", "conv1d", "conv2d",
    "conv_mean_pool2d", "deconv2d", "depth_to_space", "dropout", "embedding", "gated_nonlinearity", "gaussian_noise",
    "global_mean_pool", "gru", "gru_step", "kl_gaussian_gaussian", "kl_unit_gaussian", "l2_dense", "layernorm",
    "leaky_relu", "linear", "log_sum_exp", "lsuv_init", "make_mask", "mean_pool", "mean_pool_conv2d",
    "minibatch_discrimination", "mlp", "rnn", "rnn_step", "same_padding", "separable_conv2d", "softplus", "space_to_depth",
    "upsample_conv2d", "upsample_nearest", "wn_conv2d", "wn_deconv2d", "wn_dense",
]
