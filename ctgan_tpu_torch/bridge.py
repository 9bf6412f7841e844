"""The one place where parameters change layout between the two packages.

The JAX package stores conv filters as HWIO and linear weights as
``[in, out]``; the port computes with OIHW filters and ``[out, in]``
weights.  Both keep the JAX names.  Every other array (biases, norm
offsets and scales) is the same in both.  A round trip is exact.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["from_jax_params", "to_jax_params"]


def _kind(name: str, ndim: int) -> str:
    if name.endswith(".Filters"):
        if ndim != 4:
            raise ValueError(f"{name}: only 2-D conv filters are bridged, got ndim={ndim}")
        return "filters"
    if name.endswith(".W"):
        if ndim != 2:
            raise ValueError(f"{name}: linear weights must be 2-D, got ndim={ndim}")
        return "weight"
    return "other"


def from_jax_params(params: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """JAX-layout arrays -> port-layout fp32 CPU tensors (contiguous)."""
    out = {}
    for name, value in params.items():
        t = torch.from_numpy(np.array(value, dtype=np.float32))
        kind = _kind(name, t.ndim)
        if kind == "filters":
            t = t.permute(3, 2, 0, 1)
        elif kind == "weight":
            t = t.t()
        out[name] = t.contiguous()
    return out


def to_jax_params(params: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Port-layout tensors (any device) -> JAX-layout NumPy arrays."""
    out = {}
    for name, t in params.items():
        t = t.detach().cpu()
        kind = _kind(name, t.ndim)
        if kind == "filters":
            t = t.permute(2, 3, 1, 0)
        elif kind == "weight":
            t = t.t()
        out[name] = np.ascontiguousarray(t.numpy())
    return out
