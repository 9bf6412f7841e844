"""Weight-initialisation distributions (own copy of ``ctgan_tpu/ops/init.py``).

Every scheme is a uniform distribution with half-width ``stdev * sqrt(3)``,
drawn on the host with NumPy from a ``np.random.Generator`` in parameter
creation order, so a seed gives the same weights as the JAX package.
"""

from __future__ import annotations

import numpy as np

__all__ = ["uniform_stdev", "linear_initializer", "conv_filter_stdev"]


def uniform_stdev(rng: np.random.Generator, stdev: float, size) -> np.ndarray:
    """U(-stdev*sqrt(3), stdev*sqrt(3)): variance stdev**2."""
    lim = stdev * np.sqrt(3)
    return rng.uniform(low=-lim, high=lim, size=size).astype("float32")


def linear_initializer(rng: np.random.Generator, input_dim: int, output_dim: int) -> np.ndarray:
    """``[input_dim, output_dim]`` glorot weights (the JAX package's default
    ``initialization=None``)."""
    return uniform_stdev(rng, np.sqrt(2.0 / (input_dim + output_dim)), (input_dim, output_dim))


def conv_filter_stdev(
    input_dim: int, output_dim: int, filter_size: int, stride: int = 1, he_init: bool = True
) -> float:
    """Fan-based filter stdev: sqrt(4/(fan_in+fan_out)) for "he",
    sqrt(2/(fan_in+fan_out)) otherwise."""
    fan_in = input_dim * filter_size**2
    fan_out = output_dim * filter_size**2 / (stride**2)
    if he_init:
        return float(np.sqrt(4.0 / (fan_in + fan_out)))
    return float(np.sqrt(2.0 / (fan_in + fan_out)))
