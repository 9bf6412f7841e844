"""KL divergences of Gaussians, elementwise (counterpart of
``ctgan_tpu/ops/stats.py``)."""

from __future__ import annotations

import torch

__all__ = ["kl_gaussian_gaussian", "kl_unit_gaussian"]


def kl_gaussian_gaussian(mu1, logvar1, mu2, logvar2) -> torch.Tensor:
    """KL(N(mu1, exp(logvar1)) || N(mu2, exp(logvar2)))."""
    return 0.5 * (logvar2 - logvar1 + (torch.exp(logvar1) + (mu1 - mu2).square()) / torch.exp(logvar2) - 1.0)


def kl_unit_gaussian(mu, logvar) -> torch.Tensor:
    """KL(N(mu, exp(logvar)) || N(0, 1))."""
    return -0.5 * (1.0 + logvar - mu.square() - torch.exp(logvar))
