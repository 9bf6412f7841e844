"""Batch and layer normalisation (counterpart of ``batchnorm``,
``cond_batchnorm``, ``layernorm`` and ``cond_layernorm`` in
``ctgan_tpu/ops/norm.py``).  NCHW.

Each computes its statistics and its affine in fp32 (float64 for a float64
input) and returns the input's dtype (``ctgan_tpu/ops/norm.py:46-201``):
under the bf16 policy a bf16 activation comes back bf16, rounded once.  Mean and biased variance, eps
1e-5.

* Batch norm, as the GAN path always runs it: the current batch's
  statistics over N, H and W, then a per-channel (or, conditional, a
  per-label per-channel) scale and offset.  On the card ``F.batch_norm``
  computes it in one kernel.  On a CPU tensor the port writes out the JAX
  package's two-pass form, ``(x - mean) * rsqrt(var + eps)`` with ``var =
  mean((x - mean)^2)`` (``ctgan_tpu/ops/norm.py:36-42``): PyTorch's CPU
  kernel folds the mean into the offset, ``x * a + (b - mean * a)``, which
  loses digits when a channel's mean is large against its spread; in a
  64 px critic with batch norm it moved an fp32 gradient penalty by 1.3e-4
  of its value and its gradients by 0.9% of a tensor's scale against
  float64 (the two-pass form: 0 and 5.7e-6; tests/torch_precision_probe.py).
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


def _batch_normed(x: torch.Tensor) -> torch.Tensor:
    """The widened ``x`` normalised by its batch statistics (no affine)."""
    x = _wide(x)
    if x.device.type != "cpu":
        return F.batch_norm(x, None, None, training=True, eps=EPS)
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    centred = x - mean
    return centred * torch.rsqrt(centred.square().mean(dim=(0, 2, 3), keepdim=True) + EPS)


def batchnorm(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cpu":
        return F.batch_norm(_wide(x), None, None, weight=scale, bias=offset, training=True,
                            eps=EPS).to(x.dtype)
    return (_batch_normed(x) * _per_channel(scale) + _per_channel(offset)).to(x.dtype)


def cond_batchnorm(
    x: torch.Tensor, labels: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor
) -> torch.Tensor:
    """``scale``/``offset`` are ``[n_labels, C]`` tables looked up by label."""
    normed = _batch_normed(x)
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
