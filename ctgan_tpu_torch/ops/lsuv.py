"""Layer-sequential unit-variance initialisation (counterpart of
``ctgan_tpu/ops/lsuv.py:24-49``; Mishkin and Matas 2015): each listed
weight is divided by the square root of its layer's output variance until
that variance is within ``tol`` of 1."""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

__all__ = ["lsuv_init"]


@torch.no_grad()
def lsuv_init(params: dict, forward_to_layer: Callable, layer_weight_names: Sequence[str], rand=None, *,
              tol: float = 0.05, max_iter: int = 10) -> dict:
    """``params`` (a new dict; the tensors it does not rescale are shared)
    with each weight in ``layer_weight_names`` rescaled, in order.
    ``forward_to_layer(params, name, rand)`` runs the model and returns the
    pre-activation output of the layer that owns ``name``.  Every call
    draws the same: ``rand.for_step(0)`` afresh where ``rand`` is a
    ``core.rng.Randomness``, else ``rand`` itself, as the JAX op runs each
    call under the same key."""
    params = dict(params)
    for name in layer_weight_names:
        for _ in range(max_iter):
            draws = rand.for_step(0) if hasattr(rand, "for_step") else rand
            var = float(forward_to_layer(params, name, draws).float().var(unbiased=False))
            if abs(var - 1.0) < tol or var == 0.0:
                break
            params[name] = params[name] / math.sqrt(var)
    return params
