"""Fully-connected layer (counterpart of ``ctgan_tpu/ops/linear.py``).

Weights are ``[out, in]`` inside the port; ``ctgan_tpu_torch.bridge``
converts from and to the JAX ``[in, out]`` layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["linear"]


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ weight.T (+ bias) over the last axis."""
    return F.linear(x, weight, bias)
