"""Batch and layer normalisation (counterpart of ``batchnorm``,
``cond_batchnorm``, ``layernorm`` and ``cond_layernorm`` in
``ctgan_tpu/ops/norm.py``).  NCHW; batch norm also takes ``[N, F]``
(the DCGAN generators normalise their input linear's output per feature).

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


def _per_channel(t: torch.Tensor, ndim: int = 4) -> torch.Tensor:
    """``[C]`` -> ``[C, 1, 1]``; ``[N, C]`` -> ``[N, C, 1, 1]`` (no trailing
    axes for an ``ndim``-2 input)."""
    return t.reshape(*t.shape, *(1,) * (ndim - 2))


def _batch_normed(x: torch.Tensor) -> torch.Tensor:
    """The widened ``x`` normalised by its batch statistics over every axis
    but the channel axis 1 (no affine)."""
    x = _wide(x)
    if x.device.type != "cpu":
        return F.batch_norm(x, None, None, training=True, eps=EPS)
    axes = (0, *range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    centred = x - mean
    return centred * torch.rsqrt(centred.square().mean(dim=axes, keepdim=True) + EPS)


def batchnorm(x: torch.Tensor, scale: torch.Tensor | None, offset: torch.Tensor) -> torch.Tensor:
    """NCHW, or ``[N, F]`` with per-feature statistics.  ``scale`` None is
    the JAX package's ``scale=False``: an offset and no learned gain (the
    semi-supervised generators)."""
    if x.device.type != "cpu":
        # a unit gain in place of None: CUDA's batch-norm backward returns an
        # empty weight gradient for weight None beside a bias, which autograd refuses
        weight = torch.ones_like(offset) if scale is None else scale
        return F.batch_norm(_wide(x), None, None, weight=weight, bias=offset, training=True,
                            eps=EPS).to(x.dtype)
    normed = _batch_normed(x)
    if scale is not None:
        normed = normed * _per_channel(scale, x.ndim)
    return (normed + _per_channel(offset, x.ndim)).to(x.dtype)


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
