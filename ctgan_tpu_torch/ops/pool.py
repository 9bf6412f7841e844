"""Spatial resampling (counterpart of ``ctgan_tpu/ops/pool.py``).  NCHW."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["depth_to_space", "global_mean_pool", "mean_pool", "space_to_depth", "upsample_nearest"]


def mean_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool, stride 2."""
    return F.avg_pool2d(x, 2)


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def global_mean_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial axes: NCHW -> NC."""
    return x.mean(dim=(2, 3))


def depth_to_space(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """TF's depth-to-space on NCHW (``ctgan_tpu/ops/pool.py:27-33``):
    channel ``(i * block + j) * C + c`` of pixel ``(h, w)`` goes to channel
    ``c`` of pixel ``(h * block + i, w * block + j)``.  That is the NHWC
    channel order; ``F.pixel_shuffle`` reads channel ``c * block**2 + i *
    block + j`` instead, so it is not used."""
    n, cr, h, w = x.shape
    c = cr // (block * block)
    x = x.reshape(n, block, block, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c, h * block, w * block)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """TF's space-to-depth on NCHW (``ctgan_tpu/ops/pool.py:36-40``), the
    inverse of :func:`depth_to_space`: channel ``c`` of pixel ``(h * block
    + i, w * block + j)`` goes to channel ``(i * block + j) * C + c`` of
    pixel ``(h, w)``.  ``F.pixel_unshuffle`` writes channel ``c * block**2 +
    i * block + j`` instead, so it is not used."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // block, block, w // block, block).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, block * block * c, h // block, w // block)
