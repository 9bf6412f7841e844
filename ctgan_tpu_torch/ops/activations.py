"""Activations (counterpart of ``leaky_relu``, ``softplus``,
``centered_softplus``, ``log_sum_exp`` and ``gated_nonlinearity`` in
``ctgan_tpu/ops/activations.py:25-46``).

``leaky_relu`` is ``max(alpha * x, x)`` as the JAX package writes it, not
``F.leaky_relu``: at ``x == 0`` the maximum splits its gradient between its
two equal arguments (``1/2 * alpha + 1/2``, 0.6 at alpha 0.2), as
``jnp.maximum`` does, where ``F.leaky_relu`` gives ``alpha``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["centered_softplus", "gated_nonlinearity", "leaky_relu", "log_sum_exp", "softplus"]


def leaky_relu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    return torch.maximum(alpha * x, x)


def gated_nonlinearity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sigmoid(a) * tanh(b), the PixelCNN gate."""
    return torch.sigmoid(a) * torch.tanh(b)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it,
    ``logaddexp(x, 0)``: no threshold past which it returns ``x``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def centered_softplus(x: torch.Tensor) -> torch.Tensor:
    """``softplus(x) - log(2)``: 0 at 0 (``log(2)`` rounded to fp32 first)."""
    return softplus(x) - float(np.float32(np.log(2.0)))


def log_sum_exp(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """``m + log(sum(exp(x - m)))`` with ``m`` the maximum over ``dim``
    (``amax``: a tie shares its gradient, as ``jnp.max``'s does)."""
    m = x.amax(dim=dim)
    return m + torch.log(torch.exp(x - m.unsqueeze(dim)).sum(dim=dim))
