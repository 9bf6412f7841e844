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
* Moving statistics (``mode="moving"`` or ``"blend"``, ``update_stats``;
  ``ctgan_tpu/ops/norm.py:46-135``): for evaluation after
  ``train.recalibrate_bn``.  The JAX package keeps them in its store's
  mutable state; the port passes them as a dict in and out, under the JAX
  names ``<name>.moving_mean``, ``<name>.moving_variance`` and
  ``<name>.stats_iter`` (missing entries start at 0, 1 and 0).
  ``update_stats`` blends the batch's statistics in cumulatively, ``t/(t+1)``
  of the old and ``1/(t+1)`` of the new, and counts ``t`` up; ``"moving"``
  normalises by the stored statistics, ``"blend"`` (NCHW only) by
  ``1/N`` of each example's spatial statistics and ``(N-1)/N`` of the
  stored ones.  These run in the two-pass form on any device; the
  card's ``F.batch_norm`` serves the plain batch mode alone.
  ``per_batch_axes``: each example its own statistics over the given axes
  (the reference's non-fused branch), returned in fp32 as the JAX package
  returns it.
* Layer norm: each example's statistics over C, H and W, then a
  per-channel (or per-label per-channel) scale and offset.  The affine is
  written out, since ``F.layer_norm``'s own is per element of ``[C, H, W]``.
  It needs no communication.
"""

from __future__ import annotations

import contextlib
import math

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


def _moments(x: torch.Tensor, axes, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and biased variance of the widened ``x`` over ``axes`` (kept),
    the two-pass form; with ``group``, of the batch the processes of
    ``group`` hold together, each holding as many rows."""
    if group is None:
        mean = x.mean(dim=axes, keepdim=True)
        return mean, (x - mean).square().mean(dim=axes, keepdim=True)
    count = math.prod(x.shape[a] for a in axes) * torch.distributed.get_world_size(group)
    mean = all_reduce_sum(x.sum(dim=axes, keepdim=True), group) / count
    return mean, all_reduce_sum((x - mean).square().sum(dim=axes, keepdim=True), group) / count


def _batch_axes(x: torch.Tensor) -> tuple:
    return (0, *range(2, x.ndim))


def _batch_normed(x: torch.Tensor, group=None) -> torch.Tensor:
    """The widened ``x`` normalised by its batch statistics over every axis
    but the channel axis 1 (no affine); over ``group``'s processes where
    there is one."""
    x = _wide(x)
    if group is None and x.device.type != "cpu":
        return F.batch_norm(x, None, None, training=True, eps=EPS)
    mean, var = _moments(x, _batch_axes(x), group)
    return (x - mean) * torch.rsqrt(var + EPS)


def _stats_of(state: dict | None, name: str, c: int, device) -> tuple:
    """``(moving_mean, moving_variance, stats_iter)`` of norm ``name`` in
    ``state``, fp32 on ``device``; a missing entry at its start."""

    def get(key: str, fill: float, shape: tuple) -> torch.Tensor:
        v = (state or {}).get(f"{name}.{key}")
        return torch.full(shape, fill, dtype=torch.float32, device=device) if v is None else v.to(device, torch.float32)

    return get("moving_mean", 0.0, (c,)), get("moving_variance", 1.0, (c,)), get("stats_iter", 0.0, ())


def _moving_normed(x: torch.Tensor, mode: str, update_stats: bool, state: dict | None, name: str | None,
                   group) -> tuple[torch.Tensor, dict | None]:
    """The widened ``x`` normalised in ``mode`` with the moving statistics
    of ``name`` in ``state``, and the updated state (``update_stats``)."""
    if not name:
        raise ValueError("moving statistics need the norm's name")
    x = _wide(x)
    c = x.shape[1]
    moving_mean, moving_var, t = _stats_of(state, name, c, x.device)
    shape = (1, c, *(1,) * (x.ndim - 2))
    new_state = state
    if mode == "batch":
        mean, var = _moments(x, _batch_axes(x), group)
        if update_stats:
            old, new = t / (t + 1), 1 / (t + 1)
            new_state = dict(state or {}, **{
                f"{name}.moving_mean": old * moving_mean + new * mean.reshape(c),
                f"{name}.moving_variance": old * moving_var + new * var.reshape(c),
                f"{name}.stats_iter": t + 1})
    elif mode == "moving":
        mean, var = moving_mean.reshape(shape), moving_var.reshape(shape)
    elif mode == "blend":
        if x.ndim != 4:
            raise ValueError(f"batchnorm mode='blend' requires NCHW (4-D) input, got ndim={x.ndim}")
        bs = torch.tensor(float(x.shape[0]), dtype=torch.float32, device=x.device)
        item_mean, item_var = _moments(x, (2, 3))
        mean = (1.0 / bs) * item_mean + ((bs - 1.0) / bs) * moving_mean.reshape(shape)
        var = (1.0 / bs) * item_var + ((bs - 1.0) / bs) * moving_var.reshape(shape)
    else:
        raise ValueError(f"unknown batchnorm mode {mode!r}")
    return (x - mean) * torch.rsqrt(var + EPS), new_state


def batchnorm(x: torch.Tensor, scale: torch.Tensor | None, offset: torch.Tensor, *, group=None,
              mode: str = "batch", update_stats: bool = False, state: dict | None = None, name: str | None = None,
              per_batch_axes: tuple | None = None):
    """NCHW, or ``[N, F]`` with per-feature statistics.  ``scale`` None is
    the JAX package's ``scale=False``: an offset and no learned gain (the
    semi-supervised generators).  ``group``: statistics across processes
    (the module's docstring).

    ``mode`` ``"moving"`` or ``"blend"`` normalise with the moving
    statistics of norm ``name`` in the dict ``state``; ``update_stats``
    (with ``mode="batch"``) returns ``(y, new_state)``, ``state`` with the
    norm's statistics blended in.  ``per_batch_axes``: statistics over these
    axes only (of the port's layout), in fp32 (the module's docstring)."""
    group = group if group is not None else _GROUP[-1]
    if per_batch_axes is not None:
        xw = _wide(x)
        mean, var = _moments(xw, tuple(per_batch_axes))
        return (xw - mean) * torch.rsqrt(var + EPS) * _per_channel(scale, x.ndim) + _per_channel(offset, x.ndim)
    if mode != "batch" or update_stats:
        normed, new_state = _moving_normed(x, mode, update_stats, state, name, group)
        if scale is not None:
            normed = normed * _per_channel(scale, x.ndim)
        y = (normed + _per_channel(offset, x.ndim)).to(x.dtype)
        return (y, new_state) if update_stats else y
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
