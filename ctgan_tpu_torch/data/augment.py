"""Augmentation (own copy of ``random_flip``, ``random_crop_flip`` and
``two_stream_augment`` in ``ctgan_tpu/data/augment.py:22-64`` and of the
batch math of ``ctgan_tpu/data/hbm_input.py:68-74``).

The uint8 pool lives on the device (``DeviceSampler``); each iteration's
``[K, B, C*H*W]`` batch is scaled to [-1, 1] by ``2 * (x / 255 - 0.5)``
(no dequantisation noise, unlike the flagship's ``/ 256`` and U[0, 1/128))
and each image is flipped left to right or not.  The flips are drawn by
the caller (``Randomness.flip``), so they are the same on every device.

The semi-supervised CIFAR-10 app augments each batch on its device
(``CT_CIFAR.py:203-265`` of the reference ran a host loop over single
images): a 2 px reflect pad, a crop back to 32 x 32 at a per-image offset in
``[0, 4]`` (one gather over the batch), then a flip.  Offsets and flips come
from ``Randomness.crop_offsets`` and ``Randomness.flip``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["random_crop_flip", "random_flip", "scale_and_flip", "two_stream_augment"]


def random_flip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """NCHW ``images`` with image i mirrored along W where ``flip[i]``."""
    return torch.where(flip.reshape(-1, 1, 1, 1), images.flip(-1), images)


def scale_and_flip(raw: torch.Tensor, flip: torch.Tensor, chw: tuple[int, int, int]) -> torch.Tensor:
    """uint8-valued ``[K, B, C*H*W]`` pixels -> fp32 in [-1, 1], each of the
    ``K * B`` images flipped where ``flip`` says; same shape."""
    x = 2.0 * (raw.float() / 255.0 - 0.5)
    return random_flip(x.reshape(-1, *chw), flip).reshape(raw.shape)


def random_crop_flip(images: torch.Tensor, offsets: torch.Tensor, flip: torch.Tensor, *,
                     pad: int = 2) -> torch.Tensor:
    """NCHW ``images`` reflect-padded by ``pad``, image i cropped back to
    ``H x W`` from row ``offsets[i, 0]`` and column ``offsets[i, 1]`` (each
    in ``[0, 2 * pad]``), then mirrored where ``flip[i]``."""
    n, _, h, w = images.shape
    padded = F.pad(images, (pad, pad, pad, pad), mode="reflect")
    rows = (offsets[:, 0:1] + torch.arange(h, device=images.device))[:, None, :, None]
    cols = (offsets[:, 1:2] + torch.arange(w, device=images.device))[:, None, None, :]
    batch = torch.arange(n, device=images.device)[:, None, None, None]
    chan = torch.arange(images.shape[1], device=images.device)[None, :, None, None]
    return random_flip(padded[batch, chan, rows, cols], flip)


def two_stream_augment(images: torch.Tensor, rand, *, pad: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independently augmented copies of one batch, drawing from
    ``rand`` (offsets and flips of the first, then of the second)."""
    return tuple(random_crop_flip(images, rand.crop_offsets(len(images), pad), rand.flip(len(images)), pad=pad)
                 for _ in range(2))
