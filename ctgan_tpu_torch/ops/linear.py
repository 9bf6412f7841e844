"""Fully-connected layer (counterpart of ``ctgan_tpu/ops/linear.py``).

Weights are ``[out, in]`` inside the port; ``ctgan_tpu_torch.bridge``
converts from and to the JAX ``[in, out]`` layout.  The product runs under
the precision policy (``core.matmul``) and the bias is added in its dtype
(``ctgan_tpu/ops/linear.py:67``).
"""

from __future__ import annotations

import torch

from ..core.matmul import matmul

__all__ = ["linear"]


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ weight.T (+ bias) over the last axis."""
    out = matmul(x, weight)
    return out if bias is None else out + bias.to(out.dtype)
