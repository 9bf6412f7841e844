"""Minibatch discrimination (counterpart of ``ctgan_tpu/ops/minibatch.py:20-54``,
``nn.py:136-174`` of the reference): each example's exp-L1 closeness to
the rest of the batch in ``K`` learned projections, appended to its
features."""

from __future__ import annotations

import torch

from ..core.matmul import matmul

__all__ = ["minibatch_discrimination"]


def minibatch_discrimination(x: torch.Tensor, theta: torch.Tensor, log_weight_scale: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """``[N, in]`` -> ``[N, in + K]``.  ``theta`` ``[in, K, D]`` (as the JAX
    package stores it), normalised over ``in`` and scaled by
    ``exp(log_weight_scale)`` ``[K, D]``; ``b`` ``[K]``.  The projection runs
    in the policy's compute dtype and the distances in fp32, as the JAX op
    casts them."""
    n, (d_in, k, d) = x.shape[0], theta.shape
    w = theta * (torch.exp(log_weight_scale) / torch.sqrt(theta.square().sum(dim=0)))
    act = matmul(x, w.reshape(d_in, k * d).t()).float().reshape(n, k, d)
    abs_dif = (act[:, None, :, :] - act[None, :, :, :]).abs().sum(dim=-1)
    mask = 1.0 - torch.eye(n, dtype=act.dtype, device=act.device)
    f = (torch.exp(-abs_dif) * mask[:, :, None]).sum(dim=1) + b
    return torch.cat([x, f.to(x.dtype)], dim=1)
