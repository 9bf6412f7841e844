"""Multi-layer perceptron (counterpart of ``ctgan_tpu/ops/mlp.py``)."""

from __future__ import annotations

import torch

from .linear import linear

__all__ = ["mlp"]


def mlp(params: dict, name: str, inputs: torch.Tensor, n_layers: int, *, nonlinearity=torch.relu) -> torch.Tensor:
    """``n_layers`` linear layers (at least 3) under the JAX names
    ``<name>.Input``, ``<name>.Hidden<i>`` and ``<name>.Output`` (each
    ``.W`` ``[out, in]`` and ``.b``), ``nonlinearity`` after all but the
    last."""
    if n_layers < 3:
        raise ValueError("mlp requires n_layers >= 3 (mlp.py:29)")
    layer = lambda key, x: linear(x, params[f"{name}.{key}.W"], params[f"{name}.{key}.b"])
    out = nonlinearity(layer("Input", inputs))
    for i in range(n_layers - 2):
        out = nonlinearity(layer(f"Hidden{i}", out))
    return layer("Output", out)
