"""Additive Gaussian noise (counterpart of ``ctgan_tpu/ops/noise.py``).

``x + sigma * N(0, 1)`` while training, ``x`` when ``deterministic``: the
semi-supervised MNIST classifier perturbs its input and every hidden layer
so, and its consistency term compares two passes with independent draws.
The draw is ``rand.normal(shape)`` (``core.rng.Randomness``: the host
generator and one pinned copy, so the card and the CPU draw the same
numbers) or a test's injected draw.
"""

from __future__ import annotations

import torch

__all__ = ["gaussian_noise"]


def gaussian_noise(x: torch.Tensor, sigma: float, rand, *, deterministic: bool = False) -> torch.Tensor:
    if deterministic or sigma == 0:
        return x
    return torch.add(x, rand.normal(tuple(x.shape)).to(x.dtype), alpha=sigma)
