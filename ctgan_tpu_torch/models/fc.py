"""Fully-connected G and D (counterpart of ``ctgan_tpu/models/fc.py:14-45``):
four ReLU layers of ``fc_dim`` with "he" initialisation and a linear layer
to the flat image, ``tanh``; D, leaky-ReLU layers and a linear critic head.
Each has a ``*_params`` twin that creates its parameters in the JAX
package's order (``core.store.ParamInit``)."""

from __future__ import annotations

import torch

from ..core.store import ParamInit
from ..ops import leaky_relu, linear
from .common import noise_input

__all__ = ["fc_discriminator", "fc_discriminator_params", "fc_generator", "fc_generator_params"]

NOISE_DIM = 128
_G_LAYERS = ("Generator.1.Linear", "Generator.2.Linear", "Generator.3.Linear", "Generator.4.Linear")


def _lin(p, name: str, x: torch.Tensor) -> torch.Tensor:
    return linear(x, p[name + ".W"], p[name + ".b"])


def fc_generator(p, n_samples: int, rand, *, noise: torch.Tensor | None = None) -> torch.Tensor:
    """Flat images in [-1, 1]; the output width is that of ``Generator.Out``."""
    out = noise_input(n_samples, NOISE_DIM, noise, rand)
    for name in _G_LAYERS:
        out = torch.relu(_lin(p, name, out))
    return torch.tanh(_lin(p, "Generator.Out", out))


def fc_generator_params(init: ParamInit, output_dim: int = 64 * 64 * 3, fc_dim: int = 512) -> None:
    for name, d_in in zip(_G_LAYERS, (NOISE_DIM, fc_dim, fc_dim, fc_dim)):
        init.linear(name, d_in, fc_dim, initialization="he")
    init.linear("Generator.Out", fc_dim, output_dim)


def fc_discriminator(p, inputs: torch.Tensor, rand=None, *, n_layers: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """``(logits [N], the last hidden layer [N, fc_dim])``."""
    out = leaky_relu(_lin(p, "Discriminator.Input.Linear", inputs))
    for i in range(n_layers):
        out = leaky_relu(_lin(p, f"Discriminator.{i}.Linear", out))
    return _lin(p, "Discriminator.Out", out).reshape(-1), out


def fc_discriminator_params(init: ParamInit, input_dim: int = 64 * 64 * 3, fc_dim: int = 512,
                            n_layers: int = 3) -> None:
    init.linear("Discriminator.Input.Linear", input_dim, fc_dim, initialization="he")
    for i in range(n_layers):
        init.linear(f"Discriminator.{i}.Linear", fc_dim, fc_dim, initialization="he")
    init.linear("Discriminator.Out", fc_dim, 1)
