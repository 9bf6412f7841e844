"""The 128x128 LSUN ResNet G and D (counterpart of ``lsun128_generator`` and
``lsun128_discriminator`` in ``ctgan_tpu/models/lsun128.py``).  NCHW.

G: a linear layer to ``[4, 4, dim_g_4]``, four up-sampling stride blocks
(1024 -> 512 -> 256 -> 128 -> 128 channels, 4 -> 64 px) with batch norm,
batch norm, ReLU, a scaled upsample 5x5 conv to RGB at 128 px and ``tanh``.
D: a stride-2 5x5 conv (128 -> 64 px), three down-sampling stride blocks
(128 -> 256 -> 512 -> 1024 channels, 64 -> 8 px) and two 8 px blocks at
1024 channels, each with layer norm, dropout after the third down block and
after each 8 px block (keep 0.8, 0.5, 0.5 in training), the spatial mean and
a linear critic head.  With the defaults every mask is ``[N, 1024, 8, 8]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.store import ParamInit
from ..ops import batchnorm, conv2d, dropout, global_mean_pool, layernorm, linear
from .blocks import residual_block_stride, residual_block_stride_params, scaled_upsample_conv_params, upsample_conv
from .common import flat_to_nchw, nchw_to_flat, noise_input

__all__ = ["KP", "Lsun128Config", "discriminator", "generator", "init_params", "zero_grad_params"]

NOISE_DIM = 128
KP = (0.8, 0.5, 0.5)


@dataclass(frozen=True)
class Lsun128Config:
    dim_g_4: int = 1024
    dim_g_8: int = 512
    dim_g_16: int = 256
    dim_g_32: int = 128
    dim_g_64: int = 128
    dim_d_64: int = 128
    dim_d_32: int = 256
    dim_d_16: int = 512
    dim_d_8: int = 1024
    normalization_g: bool = True
    normalization_d: bool = True


def _g_blocks(cfg: Lsun128Config):
    """(name, in, out) of G's up blocks."""
    dims = (cfg.dim_g_4, cfg.dim_g_8, cfg.dim_g_16, cfg.dim_g_32, cfg.dim_g_64)
    return [(f"Generator.{4 * 2 ** i}_3", dims[i], dims[i + 1]) for i in range(4)]


def _d_blocks(cfg: Lsun128Config):
    """(name, in, out, resample) of D's blocks."""
    return [("Discriminator.64_3", cfg.dim_d_64, cfg.dim_d_32, "down"),
            ("Discriminator.32_3", cfg.dim_d_32, cfg.dim_d_16, "down"),
            ("Discriminator.16_3", cfg.dim_d_16, cfg.dim_d_8, "down"),
            ("Discriminator.8_1", cfg.dim_d_8, cfg.dim_d_8, None),
            ("Discriminator.8_2", cfg.dim_d_8, cfg.dim_d_8, None)]


def _identity(name, x, labels):
    return x


def _g_norm(p, cfg: Lsun128Config):
    if not cfg.normalization_g:
        return _identity
    return lambda name, x, labels: batchnorm(x, p[name + ".scale"], p[name + ".offset"])


def _d_norm(p, cfg: Lsun128Config):
    if not cfg.normalization_d:
        return _identity
    return lambda name, x, labels: layernorm(x, p[name + ".scale"], p[name + ".offset"])


def generator(p, n_samples: int, rand, *, cfg: Lsun128Config = Lsun128Config(),
              noise: torch.Tensor | None = None) -> torch.Tensor:
    """Flat ``[n, 3 * 128 * 128]`` images in [-1, 1]
    (``ctgan_tpu/models/lsun128.py:53-71``)."""
    norm = _g_norm(p, cfg)
    z = noise_input(n_samples, NOISE_DIM, noise, rand)
    out = linear(z, p["Generator.Input.W"], p["Generator.Input.b"])
    # the JAX model reshapes the linear output as NHWC [n, 4, 4, dim_g_4]
    out = out.reshape(-1, 4, 4, cfg.dim_g_4).permute(0, 3, 1, 2)
    for name, cin, cout in _g_blocks(cfg):
        out = residual_block_stride(p, name, out, input_dim=cin, output_dim=cout, resample="up",
                                    normalize=norm, fuse_meanpool=False)
    out = torch.relu(norm("Generator.OutputN", out, None))
    out = upsample_conv(p, "Generator.Output", out)  # the scaled upsample conv: its gain is in the parameter
    return nchw_to_flat(torch.tanh(out))


def discriminator(p, inputs: torch.Tensor, rand, *, cfg: Lsun128Config = Lsun128Config(), kps=KP,
                  fuse_meanpool: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``(logits [N], features [N, dim_d_8])`` (``ctgan_tpu/models/lsun128.py:74-98``);
    masks from ``rand.dropout_mask`` at keep probabilities ``kps`` (1s:
    no dropout, the JAX model's ``deterministic``).  The down blocks'
    shortcut pools then convolves, or with ``fuse_meanpool`` runs the
    stride-2 rewrite; the JAX app keeps it off."""
    norm = _d_norm(p, cfg)
    out = flat_to_nchw(inputs, 3, 128, 128)
    out = conv2d(out, p["Discriminator.Input.Filters"], p["Discriminator.Input.Biases"], stride=2)
    blocks = _d_blocks(cfg)
    for (name, cin, cout, resample), kp in zip(blocks, (1.0, 1.0, *kps)):
        out = residual_block_stride(p, name, out, input_dim=cin, output_dim=cout, resample=resample,
                                    normalize=norm, fuse_meanpool=fuse_meanpool)
        out = dropout(out, kp, rand)
    features = global_mean_pool(out)
    logits = linear(features, p["Discriminator.Output.W"], p["Discriminator.Output.b"])
    return logits.reshape(-1), features


def init_params(cfg: Lsun128Config = Lsun128Config(), seed: int = 0) -> dict[str, np.ndarray]:
    """Fresh G and D parameters in the JAX layout, equal to what
    ``ctgan_tpu``'s ``init_context(seed)`` creates for the generator and
    then the discriminator (``ctgan_tpu/apps/wgan_lsun128.py:95-97``)."""
    init = ParamInit(seed)
    no_norm = lambda name, channels: None
    g_norm = init.norm if cfg.normalization_g else no_norm
    d_norm = init.norm if cfg.normalization_d else no_norm
    init.linear("Generator.Input", NOISE_DIM, 4 * 4 * cfg.dim_g_4)
    for name, cin, cout in _g_blocks(cfg):
        residual_block_stride_params(init, name, input_dim=cin, output_dim=cout, filter_size=3, resample="up",
                                     norm=g_norm)
    g_norm("Generator.OutputN", cfg.dim_g_64)
    scaled_upsample_conv_params(init, "Generator.Output", cfg.dim_g_64, 3, 5, he_init=False)
    init.conv("Discriminator.Input", 3, cfg.dim_d_64, 5, stride=2)
    for name, cin, cout, resample in _d_blocks(cfg):
        residual_block_stride_params(init, name, input_dim=cin, output_dim=cout, filter_size=3,
                                     resample=resample, norm=d_norm)
    init.linear("Discriminator.Output", cfg.dim_d_8, 1)
    return init.params


def zero_grad_params(cfg: Lsun128Config = Lsun128Config()) -> list[str]:
    """Parameters whose WGAN training gradient is zero in exact arithmetic
    (see ``models.good64.zero_grad_params``): with batch norm in G, the conv
    biases of G's blocks, per-channel constants that reach the output only
    through batch norms and 1x1 shortcut convs up to ``Generator.OutputN``;
    and the critic's output bias."""
    names = []
    if cfg.normalization_g:
        names = [f"{name}.{conv}.Biases" for name, _, _ in _g_blocks(cfg) for conv in ("Shortcut", "Conv1", "Conv2")]
    return names + ["Discriminator.Output.b"]
