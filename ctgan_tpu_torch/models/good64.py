"""The 64x64 "Good" ResNet G and D (counterpart of ``good64_generator`` and
``good64_discriminator`` in ``ctgan_tpu/models/good64.py:36-84``) and the
101-layer bottleneck ResNet G and D (``resnet101_64_generator`` and
``_discriminator``, ``ctgan_tpu/models/good64.py:85-138``).  NCHW.

G: a linear layer to ``[4, 4, 8 dim]``, four up-sampling residual blocks
(8, 4, 2, 1 times ``dim`` channels, 4 -> 64 px) with batch norm, batch
norm, ReLU, a 3x3 conv to RGB and ``tanh``.  D: a 3x3 conv, four
down-sampling residual blocks (2, 4, 8, 8 times ``dim``, 64 -> 4 px) with
dropout after blocks 2-4 (keep 0.8, 0.5, 0.5 in training) and a linear
critic head.  D's blocks use layer norm when ``mode == "wgan-ct"`` (that
exact string) and batch norm otherwise (``ctgan_tpu/models/good64.py:70``);
batch norm uses the statistics of the batch it is given, so in D it couples
the examples of each separate pass.

D's features are flattened in the JAX package's NHWC order, so that
``Discriminator.Output.W`` (``[8192, 1]`` at dim 64 in the JAX layout)
reads the same rows in both packages.

The 101-layer ResNet (``ARCH resnet101``): G a linear layer to ``[4, 4, 8
dim]``, bottleneck blocks (6 at each of 4, 8, 16 and 32 px, 5 at 64 px, one
"up" block between) with batch norm, a 1x1 conv to RGB and ``tanh(out /
5)``; D a 1x1 conv to ``dim / 2`` channels, bottleneck blocks (5 at 64 px, 6
at each of 32, 16, 8 and 4 px, one "down" block between) with layer norm,
whatever the mode, and logits divided by 5.  It has no dropout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.store import ParamInit
from ..ops import batchnorm, conv2d, dropout, layernorm, linear
from .blocks import (
    bottleneck_residual_block,
    bottleneck_residual_block_params,
    residual_block,
    residual_block_params,
)
from .common import flat_to_nchw, nchw_to_flat, noise_input

__all__ = [
    "KP", "discriminator", "generator", "init_params", "resnet101_discriminator", "resnet101_generator",
    "resnet101_init_params", "zero_grad_params",
]

NOISE_DIM = 128
KP = (0.8, 0.5, 0.5)
_G_BLOCKS = ((1, 8, 8), (2, 8, 4), (3, 4, 2), (4, 2, 1))  # (index, in, out) in units of dim
_D_BLOCKS = ((1, 1, 2), (2, 2, 4), (3, 4, 8), (4, 8, 8))


def _batchnorm(p):
    return lambda name, x, labels: batchnorm(x, p[name + ".scale"], p[name + ".offset"])


def _d_normalize(p, mode: str):
    if mode == "wgan-ct":
        return lambda name, x, labels: layernorm(x, p[name + ".scale"], p[name + ".offset"])
    return _batchnorm(p)


def generator(p, n_samples: int, rand, *, dim: int = 64,
              noise: torch.Tensor | None = None) -> torch.Tensor:
    """Flat ``[n, 12288]`` images in [-1, 1]."""
    z = noise_input(n_samples, NOISE_DIM, noise, rand)
    out = linear(z, p["Generator.Input.W"], p["Generator.Input.b"])
    # the JAX model reshapes the linear output as NHWC [n, 4, 4, 8 dim]
    out = out.reshape(-1, 4, 4, 8 * dim).permute(0, 3, 1, 2)
    for i, cin, cout in _G_BLOCKS:
        out = residual_block(
            p, f"Generator.Res{i}", out, input_dim=cin * dim, output_dim=cout * dim,
            resample="up", labels=None, normalize=_batchnorm(p), fuse_meanpool=False,
        )
    out = torch.relu(batchnorm(out, p["Generator.OutputN.scale"], p["Generator.OutputN.offset"]))
    out = conv2d(out, p["Generator.Output.Filters"], p["Generator.Output.Biases"])
    return nchw_to_flat(torch.tanh(out))


def discriminator(p, inputs: torch.Tensor, rand, *, dim: int = 64, kps=KP, mode: str = "wgan-ct",
                  fuse_meanpool: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """``(logits [N], features [N, 16 * 8 dim])``; masks from
    ``rand.dropout_mask``, keep probabilities ``kps`` (1s: no dropout)."""
    out = flat_to_nchw(inputs, 3, 64, 64)
    out = conv2d(out, p["Discriminator.Input.Filters"], p["Discriminator.Input.Biases"])
    norm = _d_normalize(p, mode)
    for (i, cin, cout), kp in zip(_D_BLOCKS, (1.0, *kps)):
        out = residual_block(
            p, f"Discriminator.Res{i}", out, input_dim=cin * dim, output_dim=cout * dim,
            resample="down", labels=None, normalize=norm, fuse_meanpool=fuse_meanpool,
        )
        out = dropout(out, kp, rand)
    features = out.permute(0, 2, 3, 1).reshape(out.shape[0], -1)
    logits = linear(features, p["Discriminator.Output.W"], p["Discriminator.Output.b"])
    return logits.reshape(-1), features


def init_params(dim: int = 64, mode: str = "wgan-ct", seed: int = 0) -> dict[str, np.ndarray]:
    """Fresh G and D parameters in the JAX layout, equal to what
    ``ctgan_tpu``'s ``init_context(seed)`` creates for the generator and
    then the discriminator."""
    init = ParamInit(seed)
    init.linear("Generator.Input", NOISE_DIM, 4 * 4 * 8 * dim)
    for i, cin, cout in _G_BLOCKS:
        residual_block_params(init, f"Generator.Res{i}", input_dim=cin * dim, output_dim=cout * dim,
                              filter_size=3, resample="up", norm=init.norm)
    init.norm("Generator.OutputN", dim)
    init.conv("Generator.Output", dim, 3, 3)
    init.conv("Discriminator.Input", 3, dim, 3, he_init=False)
    for i, cin, cout in _D_BLOCKS:
        residual_block_params(init, f"Discriminator.Res{i}", input_dim=cin * dim,
                              output_dim=cout * dim, filter_size=3, resample="down", norm=init.norm)
    init.linear("Discriminator.Output", 4 * 4 * 8 * dim, 1)
    return init.params


def zero_grad_params(mode: str) -> list[str]:
    """Parameters whose training gradient is zero in exact arithmetic, so
    that a TF-Adam step on them (about lr * sign of rounding noise) may go
    either way in two correct runs (``train.optim.adam_mismatches``).

    * The conv biases of G's residual blocks: per-channel constants that
      reach the output only through batch norms (which subtract them) and
      1x1 shortcut convs (which keep them per-channel constants) up to
      ``Generator.OutputN``.
    * With batch norm in D (every mode but ``wgan-ct``), the biases of its
      blocks' first convs, which feed a batch norm directly.
    * In the WGAN modes, the critic's output bias: it cancels in the WGAN
      and CT differences, and the gradient penalty differentiates D by its
      input.
    """
    names = [f"Generator.Res{i}.{conv}.Biases" for i, _, _ in _G_BLOCKS
             for conv in ("Shortcut", "Conv1", "Conv2")]
    if mode != "wgan-ct":
        names += [f"Discriminator.Res{i}.Conv1.Biases" for i, _, _ in _D_BLOCKS]
    if mode.lower().startswith("wgan"):
        names.append("Discriminator.Output.b")
    return names


def _resnet101_g_blocks(dim: int):
    """(name, in, out, resample) of the 101-layer G's blocks
    (``ctgan_tpu/models/good64.py:92-107``)."""
    out = []
    stages = ((4, 8 * dim, 4 * dim), (8, 4 * dim, 2 * dim), (16, 2 * dim, dim), (32, dim, dim // 2))
    for stage, (size, width, cout) in enumerate(stages, start=1):
        out += [(f"Generator.{size}x{size}_{i}", width, width, None) for i in range(6)]
        out.append((f"Generator.Up{stage}", width, cout, "up"))
    out += [(f"Generator.64x64_{i}", dim // 2, dim // 2, None) for i in range(5)]
    return out


def _resnet101_d_blocks(dim: int):
    """(name, in, out, resample) of the 101-layer D's blocks
    (``ctgan_tpu/models/good64.py:119-136``)."""
    out = [(f"Discriminator.64x64_{i}", dim // 2, dim // 2, None) for i in range(5)]
    widths = ((32, dim // 2, dim), (16, dim, 2 * dim), (8, 2 * dim, 4 * dim), (4, 4 * dim, 8 * dim))
    for stage, (size, cin, cout) in enumerate(widths, start=1):
        out.append((f"Discriminator.Down{stage}", cin, cout, "down"))
        out += [(f"Discriminator.{size}x{size}_{i}", cout, cout, None) for i in range(6)]
    return out


def resnet101_generator(p, n_samples: int, rand, *, dim: int = 64,
                        noise: torch.Tensor | None = None) -> torch.Tensor:
    """Flat ``[n, 12288]`` images in [-1, 1]."""
    z = noise_input(n_samples, NOISE_DIM, noise, rand)
    out = linear(z, p["Generator.Input.W"], p["Generator.Input.b"])
    out = out.reshape(-1, 4, 4, 8 * dim).permute(0, 3, 1, 2)
    for name, cin, cout, resample in _resnet101_g_blocks(dim):
        out = bottleneck_residual_block(p, name, out, input_dim=cin, output_dim=cout, resample=resample,
                                        normalize=_batchnorm(p))
    out = conv2d(out, p["Generator.Out.Filters"], p["Generator.Out.Biases"])
    return nchw_to_flat(torch.tanh(out / 5.0))


def resnet101_discriminator(p, inputs: torch.Tensor, rand, *, dim: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """``(logits / 5 [N], features [N, 16 * 8 dim])``; no dropout, so
    ``rand`` is not read."""
    norm = _d_normalize(p, "wgan-ct")
    out = flat_to_nchw(inputs, 3, 64, 64)
    out = conv2d(out, p["Discriminator.In.Filters"], p["Discriminator.In.Biases"])
    for name, cin, cout, resample in _resnet101_d_blocks(dim):
        out = bottleneck_residual_block(p, name, out, input_dim=cin, output_dim=cout, resample=resample,
                                        normalize=norm)
    features = out.permute(0, 2, 3, 1).reshape(out.shape[0], -1)
    logits = linear(features, p["Discriminator.Output.W"], p["Discriminator.Output.b"])
    return (logits / 5.0).reshape(-1), features


def resnet101_init_params(dim: int = 64, seed: int = 0) -> dict[str, np.ndarray]:
    """Fresh G and D parameters of the 101-layer ResNet in the JAX layout,
    equal to ``init_context(seed)``'s, G first."""
    init = ParamInit(seed)
    init.linear("Generator.Input", NOISE_DIM, 4 * 4 * 8 * dim)
    for name, cin, cout, resample in _resnet101_g_blocks(dim):
        bottleneck_residual_block_params(init, name, input_dim=cin, output_dim=cout, filter_size=3,
                                         resample=resample, norm=init.norm)
    init.conv("Generator.Out", dim // 2, 3, 1, he_init=False)
    init.conv("Discriminator.In", 3, dim // 2, 1, he_init=False)
    for name, cin, cout, resample in _resnet101_d_blocks(dim):
        bottleneck_residual_block_params(init, name, input_dim=cin, output_dim=cout, filter_size=3,
                                         resample=resample, norm=init.norm)
    init.linear("Discriminator.Output", 4 * 4 * 8 * dim, 1)
    return init.params

