"""Spatial resampling (counterpart of ``ctgan_tpu/ops/pool.py``).  NCHW."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["mean_pool", "upsample_nearest", "global_mean_pool"]


def mean_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool, stride 2."""
    return F.avg_pool2d(x, 2)


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def global_mean_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial axes: NCHW -> NC."""
    return x.mean(dim=(2, 3))
