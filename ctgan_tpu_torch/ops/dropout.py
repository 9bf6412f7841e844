"""TF-semantics dropout (counterpart of ``ctgan_tpu/ops/dropout.py``).

Keep an element with probability ``keep_prob`` and scale it by
``1/keep_prob``.  The mask is made apart from ``x`` and multiplied in, so it
is a constant to autodiff (no grad flows into it) at any order: the gradient
penalty's double backward sees the same linear map as the forward.  The
mask is made in ``x.dtype``, so a bf16 activation gets a bf16 mask from the
kernel, as ``pallas_dropout`` makes it (``ctgan_tpu/kernels/dropout.py:112-130``).
"""

from __future__ import annotations

import torch

from ..kernels.dropout import dropout_mask as _kernel_mask
from ..kernels.dropout import dropout_mask_reference

__all__ = ["dropout", "make_mask"]


def make_mask(seed, shape, keep_prob, dtype: torch.dtype, device, *, slot: int = 0,
              segments=None) -> torch.Tensor:
    """The mask of ``seed`` (an int, or a seed table read at ``slot``), of
    the global elements ``segments`` (``kernels.dropout``; None: the whole
    draw).  A static ``keep_prob`` goes through the CUDA kernel's wrapper
    (the ``ctgan_tpu/ops/dropout.py:54-58`` arm); a tensor ``keep_prob``
    takes the plain version."""
    if isinstance(keep_prob, torch.Tensor):
        return dropout_mask_reference(seed, shape, keep_prob, dtype, device, slot=slot, segments=segments)
    return _kernel_mask(seed, shape, keep_prob, dtype, device, slot=slot, segments=segments)


def dropout(x: torch.Tensor, keep_prob, masks) -> torch.Tensor:
    """``x * mask``, with the mask from ``masks.dropout_mask(shape,
    keep_prob, dtype, device)`` (a :class:`ctgan_tpu_torch.core.rng.Randomness`
    or a test's injected masks).  A static ``keep_prob >= 1`` returns ``x``
    and draws nothing."""
    if not isinstance(keep_prob, torch.Tensor) and keep_prob >= 1.0:
        return x
    mask = masks.dropout_mask(tuple(x.shape), keep_prob, x.dtype, x.device)
    return x * mask
