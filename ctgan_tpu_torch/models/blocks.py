"""ResNet building blocks of the flagship (counterpart of
``ctgan_tpu/models/blocks.py``).  NCHW.

``p`` is the flat parameter dict; each block reads its parameters by name.
``normalize`` is ``(name, x, labels) -> x``.  ``fuse_meanpool`` picks the
stride-2 rewrite of conv + mean pool (``ops.conv_mean_pool2d`` /
``mean_pool_conv2d``) or the plain pair; both read the same parameters.
The fused nearest-upsample conv stays off, as in the JAX package.

Each block has a ``*_params`` twin that creates its parameters in the order
the JAX block creates them (``core.store.ParamInit``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.store import ParamInit
from ..ops import conv2d, conv_mean_pool2d, mean_pool, mean_pool_conv2d, upsample_nearest

__all__ = [
    "conv_mean_pool", "mean_pool_conv", "upsample_conv", "residual_block",
    "residual_block_params", "optimized_res_block_disc1", "optimized_res_block_disc1_params",
]

NormFn = Callable[[str, torch.Tensor, "torch.Tensor | None"], torch.Tensor]


def _conv_args(p, name):
    return p[name + ".Filters"], p.get(name + ".Biases")


def conv_mean_pool(p, name: str, x: torch.Tensor, fuse_meanpool: bool) -> torch.Tensor:
    w, b = _conv_args(p, name)
    if fuse_meanpool:
        return conv_mean_pool2d(x, w, b)
    return mean_pool(conv2d(x, w, b))


def mean_pool_conv(p, name: str, x: torch.Tensor, fuse_meanpool: bool) -> torch.Tensor:
    w, b = _conv_args(p, name)
    if fuse_meanpool:
        return mean_pool_conv2d(x, w, b)
    return conv2d(mean_pool(x), w, b)


def upsample_conv(p, name: str, x: torch.Tensor) -> torch.Tensor:
    return conv2d(upsample_nearest(x), *_conv_args(p, name))


def _has_shortcut(input_dim: int, output_dim: int, resample: str | None) -> bool:
    if resample not in ("up", "down", None):
        raise ValueError(f"invalid resample {resample!r}")
    return not (output_dim == input_dim and resample is None)


def residual_block(
    p, name: str, x: torch.Tensor, *, input_dim: int, output_dim: int,
    resample: str | None, labels: torch.Tensor | None, normalize: NormFn,
    fuse_meanpool: bool,
) -> torch.Tensor:
    """Pre-activation residual block, resampling up, down or not at all
    (ctgan_tpu/models/blocks.py:131-191)."""
    conv = lambda n, v: conv2d(v, *_conv_args(p, n))
    if resample == "down":
        conv_1 = conv
        conv_2 = lambda n, v: conv_mean_pool(p, n, v, fuse_meanpool)
        conv_shortcut = conv_2
    elif resample == "up":
        conv_1 = lambda n, v: upsample_conv(p, n, v)
        conv_2 = conv
        conv_shortcut = conv_1
    else:
        conv_1 = conv_2 = conv_shortcut = conv
    if _has_shortcut(input_dim, output_dim, resample):
        shortcut = conv_shortcut(name + ".Shortcut", x)
    else:
        shortcut = x
    out = normalize(name + ".N1", x, labels)
    out = torch.relu(out)
    out = conv_1(name + ".Conv1", out)
    out = normalize(name + ".N2", out, labels)
    out = torch.relu(out)
    out = conv_2(name + ".Conv2", out)
    return shortcut + out


def residual_block_params(
    init: ParamInit, name: str, *, input_dim: int, output_dim: int, filter_size: int,
    resample: str | None, norm: Callable[[str, int], None],
) -> None:
    """``norm(name, channels)`` creates a norm's parameters (or nothing)."""
    if _has_shortcut(input_dim, output_dim, resample):
        init.conv(name + ".Shortcut", input_dim, output_dim, 1, he_init=False)
    norm(name + ".N1", input_dim)
    conv1_out = input_dim if resample == "down" else output_dim
    init.conv(name + ".Conv1", input_dim, conv1_out, filter_size)
    norm(name + ".N2", conv1_out)
    init.conv(name + ".Conv2", conv1_out, output_dim, filter_size)


def optimized_res_block_disc1(
    p, x: torch.Tensor, fuse_meanpool: bool, name: str = "Discriminator.1"
) -> torch.Tensor:
    """First D block: conv path plus mean-pool shortcut, no norm and no
    pre-activation on the raw image (ctgan_tpu/models/blocks.py:257-264)."""
    shortcut = mean_pool_conv(p, name + ".Shortcut", x, fuse_meanpool)
    out = conv2d(x, *_conv_args(p, name + ".Conv1"))
    out = torch.relu(out)
    out = conv_mean_pool(p, name + ".Conv2", out, fuse_meanpool)
    return shortcut + out


def optimized_res_block_disc1_params(init: ParamInit, dim_d: int, name: str = "Discriminator.1") -> None:
    init.conv(name + ".Shortcut", 3, dim_d, 1, he_init=False)
    init.conv(name + ".Conv1", 3, dim_d, 3)
    init.conv(name + ".Conv2", dim_d, dim_d, 3)
