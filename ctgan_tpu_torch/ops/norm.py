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
* Batch norm across processes (``group``, JAX's ``axis_name``): the
  statistics of the global batch that the processes of a
  ``torch.distributed`` group hold together (``ctgan_tpu/ops/norm.py:36-43``
  under ``axis_name``), on any device in the two-pass form: the channel
  sums all-reduced, the mean taken, then the centred sums of squares
  all-reduced.  Autograd runs through both all-reduces (their backward
  all-reduces the cotangents, as ``SyncBatchNorm``'s does), so a gradient is
  the one-process gradient of the global batch.  A norm called without
  ``group`` takes the group of the innermost :func:`batch_group` around
  it, and none outside one: each process its own batch (ghost batch norm).
* Layer norm: each example's statistics over C, H and W, then a
  per-channel (or per-label per-channel) scale and offset.  The affine is
  written out, since ``F.layer_norm``'s own is per element of ``[C, H, W]``.
  It needs no communication.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..parallel.collectives import all_reduce_sum

__all__ = ["batch_group", "batchnorm", "cond_batchnorm", "cond_layernorm", "layernorm"]

EPS = 1e-5
_GROUP: list = [None]  # the group of the innermost batch_group


@contextlib.contextmanager
def batch_group(group):
    """Batch norms inside take their statistics over the processes of the
    ``torch.distributed`` group ``group`` (None: each process its own)."""
    _GROUP.append(group)
    try:
        yield
    finally:
        _GROUP.pop()


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _per_channel(t: torch.Tensor, ndim: int = 4) -> torch.Tensor:
    """``[C]`` -> ``[C, 1, 1]``; ``[N, C]`` -> ``[N, C, 1, 1]`` (no trailing
    axes for an ``ndim``-2 input)."""
    return t.reshape(*t.shape, *(1,) * (ndim - 2))


def _cross_rank_normed(x: torch.Tensor, group) -> torch.Tensor:
    """The widened ``x`` normalised by the statistics of the batch the
    processes of ``group`` hold together, each holding as many rows."""
    axes = (0, *range(2, x.ndim))
    count = x.numel() // x.shape[1] * torch.distributed.get_world_size(group)
    mean = all_reduce_sum(x.sum(dim=axes, keepdim=True), group) / count
    centred = x - mean
    var = all_reduce_sum(centred.square().sum(dim=axes, keepdim=True), group) / count
    return centred * torch.rsqrt(var + EPS)


def _batch_normed(x: torch.Tensor, group=None) -> torch.Tensor:
    """The widened ``x`` normalised by its batch statistics over every axis
    but the channel axis 1 (no affine); over ``group``'s processes where
    there is one."""
    x = _wide(x)
    if group is not None:
        return _cross_rank_normed(x, group)
    if x.device.type != "cpu":
        return F.batch_norm(x, None, None, training=True, eps=EPS)
    axes = (0, *range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    centred = x - mean
    return centred * torch.rsqrt(centred.square().mean(dim=axes, keepdim=True) + EPS)


def batchnorm(x: torch.Tensor, scale: torch.Tensor | None, offset: torch.Tensor, *, group=None) -> torch.Tensor:
    """NCHW, or ``[N, F]`` with per-feature statistics.  ``scale`` None is
    the JAX package's ``scale=False``: an offset and no learned gain (the
    semi-supervised generators).  ``group``: statistics across processes
    (the module's docstring)."""
    group = group if group is not None else _GROUP[-1]
    if x.device.type != "cpu" and group is None:
        # a unit gain in place of None: CUDA's batch-norm backward returns an
        # empty weight gradient for weight None beside a bias, which autograd refuses
        weight = torch.ones_like(offset) if scale is None else scale
        return F.batch_norm(_wide(x), None, None, weight=weight, bias=offset, training=True,
                            eps=EPS).to(x.dtype)
    normed = _batch_normed(x, group)
    if scale is not None:
        normed = normed * _per_channel(scale, x.ndim)
    return (normed + _per_channel(offset, x.ndim)).to(x.dtype)


def cond_batchnorm(
    x: torch.Tensor, labels: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor, *, group=None
) -> torch.Tensor:
    """``scale``/``offset`` are ``[n_labels, C]`` tables looked up by label;
    ``group`` as for :func:`batchnorm`."""
    normed = _batch_normed(x, group if group is not None else _GROUP[-1])
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
