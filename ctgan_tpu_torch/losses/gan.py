"""WGAN-CT + ACGAN losses of the flagship (counterpart of
``ctgan_tpu/losses/gan.py``).  Reductions run in fp32 whatever the
activation dtype."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

__all__ = [
    "wgan_losses", "consistency_term", "gradient_penalty", "acgan_loss", "acgan_accuracy",
]


def wgan_losses(d_real: torch.Tensor, d_fake: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(gen_cost, disc_cost) of the Wasserstein objective."""
    d_real, d_fake = d_real.float(), d_fake.float()
    return -d_fake.mean(), d_fake.mean() - d_real.mean()


def consistency_term(
    d_real: torch.Tensor, d_real_2: torch.Tensor, feat_real: torch.Tensor,
    feat_real_2: torch.Tensor, *, lambda_2: float = 2.0, factor_m: float = 0.0,
    feature_weight: float = 0.1,
) -> torch.Tensor:
    """CT = mean(max(l2*(D-D')^2 + 0.1*l2*mean((D_-D_')^2, axis=1) - M, 0))
    over two passes with independent dropout draws."""
    ct = lambda_2 * (d_real.float() - d_real_2.float()).square()
    ct = ct + lambda_2 * feature_weight * (feat_real.float() - feat_real_2.float()).square().mean(dim=1)
    return torch.clamp(ct - factor_m, min=0.0).mean()


def gradient_penalty(
    disc_fn: Callable[[torch.Tensor], torch.Tensor], real: torch.Tensor, fake: torch.Tensor,
    alpha: torch.Tensor, *, target: float = 1.0, create_graph: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mean((|grad D(x_hat)|_2 - target)^2), slopes)`` at ``x_hat = real +
    alpha * (fake - real)``.  The input gradient keeps its graph
    (``create_graph=True``), so the parameter gradient differentiates through
    it: a double backward.  An evaluation passes ``create_graph=False``: the
    penalty's value only, and the forward's graph is freed by the one
    backward."""
    x_hat = (real + alpha * (fake - real)).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(disc_fn(x_hat).float().sum(), x_hat, create_graph=create_graph)
    grads = grads.float()
    slopes = torch.sqrt(grads.square().sum(dim=tuple(range(1, grads.ndim))) + 1e-12)
    return (slopes - target).square().mean(), slopes


def acgan_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sparse softmax cross-entropy."""
    return F.cross_entropy(logits.float(), labels)


def acgan_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=1) == labels).float().mean()
