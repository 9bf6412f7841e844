"""Batch normalisation in batch mode (counterpart of ``batchnorm`` and
``cond_batchnorm`` in ``ctgan_tpu/ops/norm.py``).

The GAN path always normalises with the current batch's statistics: mean
and biased variance over N, H and W, eps 1e-5, then a per-channel (or, for
the conditional form, per-label) scale and offset.  NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["batchnorm", "cond_batchnorm"]

EPS = 1e-5


def batchnorm(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    return F.batch_norm(x, None, None, weight=scale, bias=offset, training=True, eps=EPS)


def cond_batchnorm(
    x: torch.Tensor, labels: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor
) -> torch.Tensor:
    """``scale``/``offset`` are ``[n_labels, C]`` tables looked up by label."""
    normed = F.batch_norm(x, None, None, training=True, eps=EPS)
    return normed * scale[labels][:, :, None, None] + offset[labels][:, :, None, None]
