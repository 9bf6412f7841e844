"""ResNet building blocks (counterpart of ``ctgan_tpu/models/blocks.py``):
the flagship's and the 64 px "Good" ResNet's pre-activation block, the
128 px LSUN model's stride block and the 101-layer ResNet's bottleneck
block.  NCHW.

``p`` is the flat parameter dict; each block reads its parameters by name.
``normalize`` is ``(name, x, labels) -> x``.  ``fuse_meanpool`` picks the
stride-2 rewrite of conv + mean pool (``ops.conv_mean_pool2d`` /
``mean_pool_conv2d``) or the plain pair; both read the same parameters.
The fused nearest-upsample conv (``ops.upsample_conv2d``) stays off, as in
the JAX package (``FUSE_UPSAMPLE_CONV = False``).

Each block has a ``*_params`` twin that creates its parameters in the order
the JAX block creates them (``core.store.ParamInit``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.store import ParamInit
from ..ops import conv2d, conv_mean_pool2d, deconv2d, depth_to_space, mean_pool, mean_pool_conv2d, upsample_nearest

__all__ = [
    "bottleneck_residual_block", "bottleneck_residual_block_params", "conv_mean_pool", "mean_pool_conv",
    "optimized_res_block_disc1", "optimized_res_block_disc1_params", "residual_block", "residual_block_params",
    "residual_block_stride", "residual_block_stride_params", "scaled_upsample_conv_params",
    "subpixel_conv", "upsample_conv",
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


def scaled_upsample_conv_params(init: ParamInit, name: str, input_dim: int, output_dim: int, filter_size: int,
                                *, he_init: bool = True) -> None:
    """The LSUN model's ScaledUpsampleConv (``ctgan_tpu/models/blocks.py:112-122``)
    is ``upsample_conv`` with its filter drawn times 0.5: the gain is in
    the parameter, so its forward is ``upsample_conv``."""
    init.conv(name, input_dim, output_dim, filter_size, he_init=he_init, gain=0.5)


def subpixel_conv(p, name: str, x: torch.Tensor) -> torch.Tensor:
    """A conv to 4x the channels, then ``depth_to_space`` by 2
    (``ctgan_tpu/models/blocks.py:125-128``); its filter is created as
    ``init.conv(name, in, 4 * out, k)``."""
    return depth_to_space(conv2d(x, *_conv_args(p, name)), 2)


def residual_block_stride(
    p, name: str, x: torch.Tensor, *, input_dim: int, output_dim: int, resample: str | None,
    normalize: NormFn, fuse_meanpool: bool,
) -> torch.Tensor:
    """The LSUN 128 px block (``ctgan_tpu/models/blocks.py:194-254``):
    "down" has a stride-2 ``Conv2`` and a mean-pool-then-1x1 shortcut,
    "up" scaled upsample convs (``upsample_conv``) for ``Conv1`` and the
    shortcut."""
    conv = lambda n, v: conv2d(v, *_conv_args(p, n))
    if resample == "down":
        conv_1 = conv
        conv_2 = lambda n, v: conv2d(v, *_conv_args(p, n), stride=2)
        conv_shortcut = lambda n, v: mean_pool_conv(p, n, v, fuse_meanpool)
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
    out = torch.relu(normalize(name + ".N1", x, None))
    out = conv_1(name + ".Conv1", out)
    out = torch.relu(normalize(name + ".N2", out, None))
    out = conv_2(name + ".Conv2", out)
    return shortcut + out


def residual_block_stride_params(
    init: ParamInit, name: str, *, input_dim: int, output_dim: int, filter_size: int,
    resample: str | None, norm: Callable[[str, int], None],
) -> None:
    """In the JAX block's order: Shortcut, N1, Conv1, N2, Conv2
    (``ctgan_tpu/models/blocks.py:245-254``); the stride-2 ``Conv2``'s draw
    has the stride's fan-out, the up block's the gain 0.5."""
    up = resample == "up"
    make = ((lambda n, i, o, k, **kw: scaled_upsample_conv_params(init, n, i, o, k, **kw)) if up
            else (lambda n, i, o, k, **kw: init.conv(n, i, o, k, **kw)))
    if _has_shortcut(input_dim, output_dim, resample):
        make(name + ".Shortcut", input_dim, output_dim, 1, he_init=False)
    norm(name + ".N1", input_dim)
    conv1_out = input_dim if resample == "down" else output_dim
    make(name + ".Conv1", input_dim, conv1_out, filter_size)
    norm(name + ".N2", conv1_out)
    init.conv(name + ".Conv2", conv1_out, output_dim, filter_size, stride=2 if resample == "down" else 1)


def bottleneck_residual_block(
    p, name: str, x: torch.Tensor, *, input_dim: int, output_dim: int, resample: str | None,
    normalize: NormFn,
) -> torch.Tensor:
    """The 101-layer ResNet's bottleneck block, residual scaled by 0.3
    (``ctgan_tpu/models/blocks.py:267-334``): ReLU, 1x1 ``Conv1`` to half
    the input's channels, ReLU, ``Conv1B`` (stride-2 conv "down", TF-SAME
    transposed conv "up"), ReLU, 1x1 ``Conv2`` without biases, the norm
    ``BN``.  The shortcut: a stride-2 1x1 conv "down", a 1x1
    ``subpixel_conv`` "up", a 1x1 conv when the width changes."""
    conv = lambda n, v, stride=1: conv2d(v, *_conv_args(p, n), stride=stride)
    if resample == "down":
        conv_1b = lambda n, v: conv(n, v, 2)
        conv_shortcut = conv_1b
    elif resample == "up":
        conv_1b = lambda n, v: deconv2d(v, *_conv_args(p, n))
        conv_shortcut = lambda n, v: subpixel_conv(p, n, v)
    else:
        conv_1b = conv_shortcut = conv
    if _has_shortcut(input_dim, output_dim, resample):
        shortcut = conv_shortcut(name + ".Shortcut", x)
    else:
        shortcut = x
    out = conv(name + ".Conv1", torch.relu(x))
    out = conv_1b(name + ".Conv1B", torch.relu(out))
    out = conv(name + ".Conv2", torch.relu(out))
    out = normalize(name + ".BN", out, None)
    return shortcut + 0.3 * out


def bottleneck_residual_block_params(
    init: ParamInit, name: str, *, input_dim: int, output_dim: int, filter_size: int,
    resample: str | None, norm: Callable[[str, int], None],
) -> None:
    """In the JAX block's order: Shortcut, Conv1, Conv1B, Conv2, BN."""
    if _has_shortcut(input_dim, output_dim, resample):
        if resample == "up":
            init.conv(name + ".Shortcut", input_dim, 4 * output_dim, 1, he_init=False)
        else:
            init.conv(name + ".Shortcut", input_dim, output_dim, 1, he_init=False,
                      stride=2 if resample == "down" else 1)
    init.conv(name + ".Conv1", input_dim, input_dim // 2, 1)
    if resample == "up":
        init.deconv(name + ".Conv1B", input_dim // 2, output_dim // 2, filter_size)
    else:
        init.conv(name + ".Conv1B", input_dim // 2, output_dim // 2, filter_size,
                  stride=2 if resample == "down" else 1)
    init.conv(name + ".Conv2", output_dim // 2 if resample else input_dim // 2, output_dim, 1, biases=False)
    norm(name + ".BN", output_dim)
