"""Weight-initialisation distributions (own copy of ``ctgan_tpu/ops/init.py``).

Every scheme but the orthogonal one is a uniform distribution with
half-width ``stdev * sqrt(3)`` (or a given half-width); all are drawn on the
host with NumPy from a ``np.random.Generator`` in parameter creation order,
so a seed gives the same weights as the JAX package.
Inside a :class:`WeightsStdevOverride` block every draw uses the
override's stdev instead (the DCGAN models build under 0.02).
"""

from __future__ import annotations

import numpy as np

__all__ = ["WeightsStdevOverride", "conv_filter_stdev", "linear_initializer", "orthogonal", "uniform_stdev"]


class WeightsStdevOverride:
    """Process-wide stdev override, a context stack (``set_weights_stdev``
    of the reference; ``ctgan_tpu/ops/init.py:24-49``)."""

    _stack: list[float] = []

    def __init__(self, stdev: float):
        self.stdev = stdev

    def __enter__(self):
        WeightsStdevOverride._stack.append(self.stdev)
        return self

    def __exit__(self, *exc):
        WeightsStdevOverride._stack.pop()

    @classmethod
    def current(cls) -> float | None:
        return cls._stack[-1] if cls._stack else None


def uniform_stdev(rng: np.random.Generator, stdev: float, size) -> np.ndarray:
    """U(-stdev*sqrt(3), stdev*sqrt(3)): variance stdev**2 (the override's
    stdev inside a :class:`WeightsStdevOverride` block)."""
    override = WeightsStdevOverride.current()
    if override is not None:
        stdev = override
    lim = stdev * np.sqrt(3)
    return rng.uniform(low=-lim, high=lim, size=size).astype("float32")


# stdev of each linear scheme from (input_dim, output_dim); None is glorot
_LINEAR_STDEV = {
    None: lambda i, o: np.sqrt(2.0 / (i + o)),
    "glorot": lambda i, o: np.sqrt(2.0 / (i + o)),
    "he": lambda i, o: np.sqrt(2.0 / i),
    "lecun": lambda i, o: np.sqrt(1.0 / i),
    "glorot_he": lambda i, o: np.sqrt(4.0 / (i + o)),
}


def orthogonal(rng: np.random.Generator, shape) -> np.ndarray:
    """Lasagne's orthogonal init (``ctgan_tpu/ops/init.py:58-66``): the
    left or right singular vectors of a standard normal ``[shape[0],
    prod(shape[1:])]`` matrix, whichever has that shape."""
    if len(shape) < 2:
        raise ValueError("orthogonal init needs a shape of at least 2 dimensions")
    flat_shape = (shape[0], int(np.prod(shape[1:])))
    a = rng.normal(0.0, 1.0, flat_shape)
    u, _, v = np.linalg.svd(a, full_matrices=False)
    q = u if u.shape == flat_shape else v
    return q.reshape(shape).astype("float32")


def linear_initializer(rng: np.random.Generator, input_dim: int, output_dim: int,
                       initialization: str | tuple | None = None, gain: float = 1.0) -> np.ndarray:
    """``[input_dim, output_dim]`` weights of the JAX package's linear menu
    (``ctgan_tpu/ops/init.py:69-104``), times ``gain``: glorot (the
    default, ``None``), "he", "lecun", "glorot_he", "orthogonal", or
    ``("uniform", half_width)``."""
    shape = (input_dim, output_dim)
    if initialization == "orthogonal":
        w = orthogonal(rng, shape)
    elif isinstance(initialization, (tuple, list)) and initialization[0] == "uniform":
        w = rng.uniform(low=-initialization[1], high=initialization[1], size=shape).astype("float32")
    elif initialization in _LINEAR_STDEV:
        w = uniform_stdev(rng, _LINEAR_STDEV[initialization](input_dim, output_dim), shape)
    else:
        raise ValueError(f"Invalid initialization: {initialization!r}")
    return w * gain


def conv_filter_stdev(
    input_dim: int, output_dim: int, filter_size: int, stride: int = 1, he_init: bool = True,
    transposed: bool = False,
) -> float:
    """Fan-based filter stdev: sqrt(4/(fan_in+fan_out)) for "he",
    sqrt(2/(fan_in+fan_out)) otherwise.  The stride divides fan_out, or
    fan_in for a transposed conv."""
    fan_in = input_dim * filter_size**2
    fan_out = output_dim * filter_size**2
    if transposed:
        fan_in /= stride**2
    else:
        fan_out /= stride**2
    if he_init:
        return float(np.sqrt(4.0 / (fan_in + fan_out)))
    return float(np.sqrt(2.0 / (fan_in + fan_out)))
