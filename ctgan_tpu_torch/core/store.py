"""Parameter creation and grouping (counterpart of ``init_context`` and
``split_params`` in ``ctgan_tpu/core/store.py``).

Parameters are a flat ``name -> array`` dict under the JAX package's names
(``Generator.1.Conv1.Filters``).  :class:`ParamInit` creates them in the
JAX layout (HWIO filters, HWOI transposed-conv filters, ``[in, out]``
linear weights) with NumPy, drawing from ``np.random.default_rng(seed)`` in
the order the JAX model creates them, so one seed gives the same weights in
both packages; a ``WeightsStdevOverride`` block (``ops.init``) overrides
every draw's stdev, as in the JAX package.
``ctgan_tpu_torch.bridge.from_jax_params`` then converts them to tensors.
:func:`format_param_table` and :func:`print_model_settings` are the apps'
start-up printouts (``ctgan_tpu/core/store.py:266-290``).
"""

from __future__ import annotations

import re
from typing import Callable, Mapping

import numpy as np

from ..ops.init import conv_filter_stdev, linear_initializer, uniform_stdev

__all__ = ["ParamInit", "split_params", "param_count", "format_param_table", "print_model_settings"]


class ParamInit:
    """Creates each named parameter once, in call order."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.params: dict[str, np.ndarray] = {}

    def add(self, name: str, make: Callable[[], np.ndarray]) -> None:
        if name not in self.params:
            self.params[name] = np.asarray(make(), dtype="float32")

    def conv(self, name: str, input_dim: int, output_dim: int, filter_size: int,
             *, he_init: bool = True, stride: int = 1, gain: float = 1.0, biases: bool = True) -> None:
        """An HWIO filter, its draw times ``gain`` (the scaled upsample
        conv's 0.5), then biases unless ``biases`` is off."""
        stdev = conv_filter_stdev(input_dim, output_dim, filter_size, stride, he_init)
        self.add(name + ".Filters", lambda: uniform_stdev(
            self.rng, stdev, (filter_size, filter_size, input_dim, output_dim)) * gain)
        if biases:
            self.add(name + ".Biases", lambda: np.zeros(output_dim, "float32"))

    def deconv(self, name: str, input_dim: int, output_dim: int, filter_size: int,
               *, he_init: bool = True, stride: int = 2, biases: bool = True) -> None:
        """A transposed conv: an HWOI ``[k, k, out, in]`` filter and biases."""
        stdev = conv_filter_stdev(input_dim, output_dim, filter_size, stride, he_init, transposed=True)
        self.add(name + ".Filters", lambda: uniform_stdev(
            self.rng, stdev, (filter_size, filter_size, output_dim, input_dim)))
        if biases:
            self.add(name + ".Biases", lambda: np.zeros(output_dim, "float32"))

    def linear(self, name: str, input_dim: int, output_dim: int, initialization: str | None = None,
               *, biases: bool = True) -> None:
        self.add(name + ".W", lambda: linear_initializer(self.rng, input_dim, output_dim, initialization))
        if biases:
            self.add(name + ".b", lambda: np.zeros(output_dim, "float32"))

    def norm(self, name: str, channels: int, n_labels: int | None = None, *, scale: bool = True) -> None:
        """Offset and scale of a batch or layer norm; per-label tables when
        ``n_labels`` is given (the conditional norms); the offset alone
        without ``scale``."""
        shape = (channels,) if n_labels is None else (n_labels, channels)
        self.add(name + ".offset", lambda: np.zeros(shape, "float32"))
        if scale:
            self.add(name + ".scale", lambda: np.ones(shape, "float32"))

    def weightnormed(self, name: str, shape: tuple, output_dim: int, w_stdev: float = 0.05,
                     *, g_and_b: bool = True) -> None:
        """A weight-normed layer's ``W ~ Normal(0, w_stdev)`` of the JAX
        ``shape`` (``[in, out]``, HWIO, or a transposed conv's HWOI), then
        its ``g`` (ones) and ``b`` (zeros), unless ``g_and_b`` is off (the
        L2-normalised dense layer)."""
        self.add(name + ".W", lambda: self.rng.normal(0.0, w_stdev, shape).astype("float32"))
        if g_and_b:
            self.add(name + ".g", lambda: np.ones(output_dim, "float32"))
            self.add(name + ".b", lambda: np.zeros(output_dim, "float32"))


def split_params(params: Mapping, *names: str) -> tuple[dict, ...]:
    """Partition a param dict by name substrings; the last group is the rest."""
    groups: list[dict] = [dict() for _ in names]
    rest: dict = {}
    for k, v in params.items():
        for i, n in enumerate(names):
            if n in k:
                groups[i][k] = v
                break
        else:
            rest[k] = v
    return (*groups, rest)


def param_count(params: Mapping) -> int:
    return sum(int(np.prod(tuple(v.shape))) for v in params.values())


def format_param_table(params: Mapping, title: str = "Params") -> str:
    """Name and shape of each parameter, sorted by name, and the total
    count, as the JAX package prints them."""
    lines = [f"{title}:"]
    total = 0
    for k in sorted(params):
        shape = tuple(params[k].shape)
        total += int(np.prod(shape)) if shape else 1
        lines.append(f"\t{k} ({','.join(map(str, shape))})")
    lines.append(f"Total param count: {total:,}")
    return "\n".join(lines)


_SETTING_RE = re.compile(r"^[A-Z][A-Z0-9_]*$")


def print_model_settings(scope: Mapping[str, object]) -> str:
    """Print the UPPERCASE entries of ``scope``, sorted; returns the text."""
    keys = sorted(k for k in scope if _SETTING_RE.match(k))
    out = "Uppercase local vars:\n" + "\n".join(f"\t{k}: {scope[k]!r}" for k in keys)
    print(out)
    return out
