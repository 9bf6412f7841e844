"""Augmentation of the 64 px input path (own copy of ``random_flip`` in
``ctgan_tpu/data/augment.py`` and of the batch math of
``ctgan_tpu/data/hbm_input.py:68-74``).

The uint8 pool lives on the device (``DeviceSampler``); each iteration's
``[K, B, C*H*W]`` batch is scaled to [-1, 1] by ``2 * (x / 255 - 0.5)``
(no dequantisation noise, unlike the flagship's ``/ 256`` and U[0, 1/128))
and each image is flipped left to right or not.  The flips are drawn by
the caller (``Randomness.flip``), so they are the same on every device.
"""

from __future__ import annotations

import torch

__all__ = ["random_flip", "scale_and_flip"]


def random_flip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """NCHW ``images`` with image i mirrored along W where ``flip[i]``."""
    return torch.where(flip.reshape(-1, 1, 1, 1), images.flip(-1), images)


def scale_and_flip(raw: torch.Tensor, flip: torch.Tensor, chw: tuple[int, int, int]) -> torch.Tensor:
    """uint8-valued ``[K, B, C*H*W]`` pixels -> fp32 in [-1, 1], each of the
    ``K * B`` images flipped where ``flip`` says; same shape."""
    x = 2.0 * (raw.float() / 255.0 - 0.5)
    return random_flip(x.reshape(-1, *chw), flip).reshape(raw.shape)
