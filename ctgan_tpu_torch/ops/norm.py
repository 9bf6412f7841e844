"""Batch and layer normalisation (counterpart of ``batchnorm``,
``cond_batchnorm``, ``layernorm`` and ``cond_layernorm`` in
``ctgan_tpu/ops/norm.py``).  NCHW.

Each computes its statistics and its affine in fp32 (float64 for a float64
input) and returns the input's dtype (``ctgan_tpu/ops/norm.py:46-201``):
under the bf16 policy a bf16 activation comes back bf16, rounded once.  Mean and biased variance, eps
1e-5.

* Batch norm, as the GAN path always runs it: the current batch's
  statistics over N, H and W, then a per-channel (or, conditional, a
  per-label per-channel) scale and offset.
* Layer norm: each example's statistics over C, H and W, then a
  per-channel (or per-label per-channel) scale and offset.  The affine is
  written out, since ``F.layer_norm``'s own is per element of ``[C, H, W]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["batchnorm", "cond_batchnorm", "cond_layernorm", "layernorm"]

EPS = 1e-5


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _per_channel(t: torch.Tensor) -> torch.Tensor:
    """``[C]`` -> ``[C, 1, 1]``; ``[N, C]`` -> ``[N, C, 1, 1]``."""
    return t[..., None, None]


def batchnorm(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    return F.batch_norm(_wide(x), None, None, weight=scale, bias=offset, training=True,
                        eps=EPS).to(x.dtype)


def cond_batchnorm(
    x: torch.Tensor, labels: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor
) -> torch.Tensor:
    """``scale``/``offset`` are ``[n_labels, C]`` tables looked up by label."""
    normed = F.batch_norm(_wide(x), None, None, training=True, eps=EPS)
    return (normed * _per_channel(scale[labels]) + _per_channel(offset[labels])).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """``scale``/``offset`` are ``[C]``."""
    normed = F.layer_norm(_wide(x), x.shape[1:], eps=EPS)
    return (normed * _per_channel(scale) + _per_channel(offset)).to(x.dtype)


def cond_layernorm(
    x: torch.Tensor, labels: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor
) -> torch.Tensor:
    """``scale``/``offset`` are ``[n_labels, C]`` tables looked up by label."""
    normed = F.layer_norm(_wide(x), x.shape[1:], eps=EPS)
    return (normed * _per_channel(scale[labels]) + _per_channel(offset[labels])).to(x.dtype)
