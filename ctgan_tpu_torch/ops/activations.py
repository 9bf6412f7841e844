"""Activations of the DCGAN family (counterpart of ``leaky_relu`` and
``gated_nonlinearity`` in ``ctgan_tpu/ops/activations.py:25-46``).

``leaky_relu`` is ``max(alpha * x, x)`` as the JAX package writes it, not
``F.leaky_relu``: at ``x == 0`` the maximum splits its gradient between its
two equal arguments (``1/2 * alpha + 1/2``, 0.6 at alpha 0.2), as
``jnp.maximum`` does, where ``F.leaky_relu`` gives ``alpha``.
"""

from __future__ import annotations

import torch

__all__ = ["gated_nonlinearity", "leaky_relu"]


def leaky_relu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    return torch.maximum(alpha * x, x)


def gated_nonlinearity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sigmoid(a) * tanh(b), the PixelCNN gate."""
    return torch.sigmoid(a) * torch.tanh(b)
