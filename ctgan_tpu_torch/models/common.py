"""Model boundary (counterpart of ``ctgan_tpu/models/common.py``).

Models take and return *flat* images in channel-major order, ``[N, C*H*W]``
(CIFAR batches are ``[N, 3072]``).  That is NCHW flattened, so inside the
port the boundary is a reshape and nothing moves.
"""

from __future__ import annotations

import torch

__all__ = ["flat_to_nchw", "nchw_to_flat", "noise_input"]


def flat_to_nchw(x: torch.Tensor, c: int, h: int, w: int) -> torch.Tensor:
    return x.reshape(-1, c, h, w)


def nchw_to_flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def noise_input(n_samples: int, dim: int, noise: torch.Tensor | None, rand) -> torch.Tensor:
    """``noise`` if given, else a fresh ``[n_samples, dim]`` normal draw."""
    if noise is not None:
        return noise
    return rand.noise(n_samples, dim)
