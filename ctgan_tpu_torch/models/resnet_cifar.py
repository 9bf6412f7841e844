"""Conditional ResNet CT-GAN for CIFAR-10, the flagship model (counterpart
of ``ctgan_tpu/models/resnet_cifar.py``).

A generator of three up-sampling residual blocks with (conditional) batch
norm, and a discriminator of four blocks with dropout after blocks 2-4,
global mean-pool features, a WGAN head and an ACGAN head.  With
``conditional`` and ``acgan`` the generator's norms are conditioned on the
labels and the discriminator's trunk is label-blind.  ``normalization_d``
adds a layer norm to D's residual blocks: conditional on the labels when
the model is conditional without ACGAN, plain otherwise.

Under the bf16 policy the dtypes flow as in the JAX model: G's convs,
norms and ``tanh`` return bf16, so fakes enter D as bf16; D's outputs are
bf16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.store import ParamInit
from ..ops import (
    batchnorm,
    cond_batchnorm,
    cond_layernorm,
    conv2d,
    dropout,
    global_mean_pool,
    layernorm,
    linear,
)
from .blocks import (
    optimized_res_block_disc1,
    optimized_res_block_disc1_params,
    residual_block,
    residual_block_params,
)
from .common import flat_to_nchw, nchw_to_flat, noise_input

__all__ = [
    "ResnetCifarConfig", "DiscOut", "generator", "discriminator", "init_params",
    "zero_grad_params",
]

NOISE_DIM = 128


@dataclass(frozen=True)
class ResnetCifarConfig:
    dim_g: int = 128
    dim_d: int = 128
    n_labels: int = 10
    conditional: bool = True
    acgan: bool = True
    normalization_g: bool = True
    normalization_d: bool = False
    fuse_meanpool: bool = True

    @property
    def d_norm_conditional(self) -> bool:
        """D's layer norms read the labels only when the model is
        conditional without ACGAN: an ACGAN D's trunk is label-blind
        (ctgan_tpu/models/resnet_cifar.py:71-83)."""
        return self.conditional and not self.acgan


class DiscOut(NamedTuple):
    wgan: torch.Tensor              # [N] critic scores
    features: torch.Tensor          # [N, dim_d] pooled features
    acgan: torch.Tensor | None      # [N, n_labels] logits, or None


def _g_normalize(p, cfg: ResnetCifarConfig):
    def norm(name, x, labels):
        if not cfg.normalization_g:
            return x
        if cfg.conditional and labels is not None:
            return cond_batchnorm(x, labels, p[name + ".scale"], p[name + ".offset"])
        return batchnorm(x, p[name + ".scale"], p[name + ".offset"])

    return norm


def _d_normalize(p, cfg: ResnetCifarConfig):
    def norm(name, x, labels):
        if not cfg.normalization_d:
            return x
        if cfg.d_norm_conditional and labels is not None:
            return cond_layernorm(x, labels, p[name + ".scale"], p[name + ".offset"])
        return layernorm(x, p[name + ".scale"], p[name + ".offset"])

    return norm


def generator(
    p, n_samples: int, labels: torch.Tensor | None, cfg: ResnetCifarConfig, rand,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Flat ``[n, 3072]`` images in [-1, 1] (ctgan_tpu/models/resnet_cifar.py:86-108)."""
    if not cfg.conditional:
        labels = None
    norm = _g_normalize(p, cfg)
    z = noise_input(n_samples, NOISE_DIM, noise, rand)
    out = linear(z, p["Generator.Input.W"], p["Generator.Input.b"])
    # the JAX model reshapes the linear output as NHWC [n, 4, 4, dim]
    out = out.reshape(-1, 4, 4, cfg.dim_g).permute(0, 3, 1, 2)
    for i in (1, 2, 3):
        out = residual_block(
            p, f"Generator.{i}", out, input_dim=cfg.dim_g, output_dim=cfg.dim_g,
            resample="up", labels=labels, normalize=norm, fuse_meanpool=cfg.fuse_meanpool,
        )
    out = norm("Generator.OutputN", out, None)
    out = torch.relu(out)
    out = conv2d(out, p["Generator.Output.Filters"], p["Generator.Output.Biases"])
    return nchw_to_flat(torch.tanh(out))


def discriminator(
    p, inputs: torch.Tensor, labels: torch.Tensor | None, kps, cfg: ResnetCifarConfig, rand,
) -> DiscOut:
    """``kps`` are the keep probabilities of the three dropouts (0.8, 0.5,
    0.5 in training, 1s for the clean pass); masks come from
    ``rand.dropout_mask`` (ctgan_tpu/models/resnet_cifar.py:111-149)."""
    kp1, kp2, kp3 = kps
    if not cfg.conditional:
        labels = None
    out = flat_to_nchw(inputs, 3, 32, 32)
    out = optimized_res_block_disc1(p, out, cfg.fuse_meanpool)
    block = dict(input_dim=cfg.dim_d, output_dim=cfg.dim_d, labels=labels,
                 normalize=_d_normalize(p, cfg), fuse_meanpool=cfg.fuse_meanpool)
    out = residual_block(p, "Discriminator.2", out, resample="down", **block)
    out = dropout(out, kp1, rand)
    out = residual_block(p, "Discriminator.3", out, resample=None, **block)
    out = dropout(out, kp2, rand)
    out = residual_block(p, "Discriminator.4", out, resample=None, **block)
    out = dropout(out, kp3, rand)
    out = torch.relu(out)
    features = global_mean_pool(out)
    wgan = linear(features, p["Discriminator.Output.W"], p["Discriminator.Output.b"]).reshape(-1)
    acgan = None
    if cfg.conditional and cfg.acgan:
        acgan = linear(features, p["Discriminator.ACGANOutput.W"], p["Discriminator.ACGANOutput.b"])
    return DiscOut(wgan, features, acgan)


def init_params(cfg: ResnetCifarConfig, seed: int = 0) -> dict[str, np.ndarray]:
    """Fresh G and D parameters in the JAX layout, equal to what
    ``ctgan_tpu``'s ``init_context(seed)`` creates for ``generator`` then
    ``discriminator``."""
    init = ParamInit(seed)

    def g_norm(name, channels, conditional=True):
        if cfg.normalization_g:
            n_labels = cfg.n_labels if cfg.conditional and conditional else None
            init.norm(name, channels, n_labels)

    init.linear("Generator.Input", NOISE_DIM, 4 * 4 * cfg.dim_g)
    for i in (1, 2, 3):
        residual_block_params(
            init, f"Generator.{i}", input_dim=cfg.dim_g, output_dim=cfg.dim_g,
            filter_size=3, resample="up", norm=g_norm,
        )
    g_norm("Generator.OutputN", cfg.dim_g, conditional=False)
    init.conv("Generator.Output", cfg.dim_g, 3, 3, he_init=False)

    def d_norm(name, channels):
        if cfg.normalization_d:
            init.norm(name, channels, cfg.n_labels if cfg.d_norm_conditional else None)

    optimized_res_block_disc1_params(init, cfg.dim_d)
    for i, resample in ((2, "down"), (3, None), (4, None)):
        residual_block_params(
            init, f"Discriminator.{i}", input_dim=cfg.dim_d, output_dim=cfg.dim_d,
            filter_size=3, resample=resample, norm=d_norm,
        )
    init.linear("Discriminator.Output", cfg.dim_d, 1)
    if cfg.conditional and cfg.acgan:
        init.linear("Discriminator.ACGANOutput", cfg.dim_d, cfg.n_labels)
    return init.params


def zero_grad_params(cfg: ResnetCifarConfig) -> list[str]:
    """Parameters whose training gradient is zero in exact arithmetic, so
    that what a run computes for it is rounding noise, and the sign of a
    TF-Adam step on it (about lr * sign(g)) is noise too.  Comparisons of
    two runs allow each of their elements up to 2 * lr per update.

    * The conv biases of the generator's residual blocks.  Each adds a
      per-channel constant, which reaches the output only through batch
      norms (which subtract it) and 1x1 shortcut convs (which keep it
      constant per channel).
    * The critic's output bias: it cancels in the WGAN difference and the CT
      difference, and the gradient penalty differentiates D by its input.
    """
    names = ["Discriminator.Output.b"]
    if cfg.normalization_g:
        names += [f"Generator.{i}.{conv}.Biases" for i in (1, 2, 3)
                  for conv in ("Shortcut", "Conv1", "Conv2")]
    return names
