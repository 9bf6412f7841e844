"""The DCGAN family (counterpart of ``ctgan_tpu/models/dcgan.py``).  NCHW.

* MNIST G and D (``CT_gan_mnist.py``): G a linear layer to ``[4, 4, 4 dim]``
  and three 5x5 stride-2 transposed convs (4 -> 8, cropped to 7, -> 14 ->
  28), ``sigmoid``; D three 5x5 stride-2 convs with leaky ReLU and dropout
  (keep 0.5) after each.  Batch norm only in mode ``wgan``.
* CIFAR-10 G and D (``CT_gan_cifar.py``): the same shapes at 32 px, batch
  norm always in G, ``tanh``; in D when ``mode != "wgan-CT"`` (that exact,
  case-sensitive string: ``wgan-ct`` puts batch norm in this D).
* 64 px (``CT_gan_64x64.py``): the DCGAN G and D, built under a 0.02 init
  stdev (``ops.init.WeightsStdevOverride``); the "crippled" WGAN-paper G
  (no batch norm, ``dim`` filters throughout, the default init); the
  "multiplicative" G and D, which gate two halves of their channels (even
  and odd) with ``sigmoid(a) * tanh(b)``.  D's norm is a layer norm in mode
  ``wgan-ct`` (lower case) and batch norm otherwise.  No dropout.

Generators return flat channel-major images; discriminators take them and
return ``(logits [N], features [N, F])``, the features being the pre-output
layer that the consistency term compares.  The JAX models are NHWC: G's
linear output is reshaped as NHWC ``[n, 4, 4, C]`` and D's features are
flattened in NHWC order, so every parameter reads the same rows here.

:func:`init_params` creates an architecture's G then D parameters in the
JAX package's order; :func:`zero_grad_params` names those whose training
gradient is zero in exact arithmetic.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.store import ParamInit
from ..ops import batchnorm, conv2d, deconv2d, dropout, gated_nonlinearity, layernorm, leaky_relu, linear
from ..ops.init import WeightsStdevOverride
from .common import flat_to_nchw, nchw_to_flat, noise_input
from .fc import fc_generator_params

__all__ = [
    "ARCHS", "cifar_discriminator", "cifar_generator", "crippled_dcgan64_generator",
    "dcgan64_discriminator", "dcgan64_generator", "init_params", "mnist_discriminator",
    "mnist_generator", "multiplicative_dcgan64_discriminator", "multiplicative_dcgan64_generator",
    "zero_grad_params",
]

NOISE_DIM = 128
KEEP_PROB = 0.5
DCGAN_STDEV = 0.02
# the architectures of init_params: the two papers' models and the 64 px app's ARCH menu
ARCHS = ("mnist", "cifar", "dcgan", "crippled", "fc", "multiplicative")
_UP64 = ((2, 8, 4), (3, 4, 2), (4, 2, 1))  # (index, in, out) in units of dim
_DOWN64 = ((2, 1, 2), (3, 2, 4), (4, 4, 8))


def _bn(p, name: str, x: torch.Tensor) -> torch.Tensor:
    return batchnorm(x, p[name + ".scale"], p[name + ".offset"])


def _conv(p, name: str, x: torch.Tensor) -> torch.Tensor:
    return conv2d(x, p[name + ".Filters"], p[name + ".Biases"], stride=2)


def _deconv(p, name: str, x: torch.Tensor) -> torch.Tensor:
    return deconv2d(x, p[name + ".Filters"], p[name + ".Biases"])


def _linear(p, name: str, x: torch.Tensor) -> torch.Tensor:
    return linear(x, p[name + ".W"], p[name + ".b"])


def _nhwc_features(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _to_nchw(x: torch.Tensor, channels: int) -> torch.Tensor:
    """A linear output ``[n, 16 C]`` read as the JAX model's NHWC ``[n, 4, 4, C]``."""
    return x.reshape(-1, 4, 4, channels).permute(0, 3, 1, 2)


def _gate(x: torch.Tensor) -> torch.Tensor:
    """Even channels gate odd ones (NHWC's last axis is NCHW's axis 1)."""
    return gated_nonlinearity(x[:, ::2], x[:, 1::2])


def _critic_head(p, out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    features = _nhwc_features(out)
    return _linear(p, "Discriminator.Output", features).reshape(-1), features


# ---------------------------------------------------------------- MNIST and CIFAR-10


def mnist_generator(p, n_samples: int, rand, *, dim: int = 64, mode: str = "wgan-CT",
                    noise: torch.Tensor | None = None) -> torch.Tensor:
    """Flat ``[n, 784]`` images in [0, 1]."""
    use_bn = mode == "wgan"
    out = _linear(p, "Generator.Input", noise_input(n_samples, NOISE_DIM, noise, rand))
    if use_bn:
        out = _bn(p, "Generator.BN1", out)
    out = _to_nchw(torch.relu(out), 4 * dim)
    for i in (2, 3):
        out = _deconv(p, f"Generator.{i}", out)
        if use_bn:
            out = _bn(p, f"Generator.BN{i}", out)
        out = torch.relu(out)
        if i == 2:
            out = out[:, :, :7, :7]  # 8x8 -> 7x7 (CT_gan_mnist.py:76)
    return nchw_to_flat(torch.sigmoid(_deconv(p, "Generator.5", out)))


def _three_conv_critic(p, out: torch.Tensor, rand, use_bn: bool, keep_prob: float):
    for i in (1, 2, 3):
        out = _conv(p, f"Discriminator.{i}", out)
        if use_bn and i > 1:
            out = _bn(p, f"Discriminator.BN{i}", out)
        out = dropout(leaky_relu(out), keep_prob, rand)
    return _critic_head(p, out)


def mnist_discriminator(p, inputs: torch.Tensor, rand, *, dim: int = 64, mode: str = "wgan-CT",
                        keep_prob: float = KEEP_PROB) -> tuple[torch.Tensor, torch.Tensor]:
    """``(logits [N], features [N, 16 * 4 dim])``; masks from
    ``rand.dropout_mask`` (none at ``keep_prob`` 1)."""
    return _three_conv_critic(p, flat_to_nchw(inputs, 1, 28, 28), rand, mode == "wgan", keep_prob)


def cifar_generator(p, n_samples: int, rand, *, dim: int = 128,
                    noise: torch.Tensor | None = None) -> torch.Tensor:
    """Flat ``[n, 3072]`` images in [-1, 1]."""
    out = _linear(p, "Generator.Input", noise_input(n_samples, NOISE_DIM, noise, rand))
    out = _to_nchw(torch.relu(_bn(p, "Generator.BN1", out)), 4 * dim)
    for i in (2, 3):
        out = torch.relu(_bn(p, f"Generator.BN{i}", _deconv(p, f"Generator.{i}", out)))
    return nchw_to_flat(torch.tanh(_deconv(p, "Generator.5", out)))


def cifar_discriminator(p, inputs: torch.Tensor, rand, *, dim: int = 128, mode: str = "wgan-CT",
                        keep_prob: float = KEEP_PROB) -> tuple[torch.Tensor, torch.Tensor]:
    """``(logits [N], features [N, 16 * 4 dim])``."""
    return _three_conv_critic(p, flat_to_nchw(inputs, 3, 32, 32), rand, mode != "wgan-CT", keep_prob)


# ---------------------------------------------------------------- 64 px


def _norm64(p, mode: str):
    if mode == "wgan-ct":
        return lambda name, x: layernorm(x, p[name + ".scale"], p[name + ".offset"])
    return lambda name, x: _bn(p, name, x)


def dcgan64_generator(p, n_samples: int, rand, *, dim: int = 64,
                      noise: torch.Tensor | None = None) -> torch.Tensor:
    """Flat ``[n, 12288]`` images in [-1, 1]."""
    out = _to_nchw(_linear(p, "Generator.Input", noise_input(n_samples, NOISE_DIM, noise, rand)), 8 * dim)
    out = torch.relu(_bn(p, "Generator.BN1", out))
    for i, _, _ in _UP64:
        out = torch.relu(_bn(p, f"Generator.BN{i}", _deconv(p, f"Generator.{i}", out)))
    return nchw_to_flat(torch.tanh(_deconv(p, "Generator.5", out)))


def crippled_dcgan64_generator(p, n_samples: int, rand, *, dim: int = 64,
                               noise: torch.Tensor | None = None) -> torch.Tensor:
    out = torch.relu(_linear(p, "Generator.Input", noise_input(n_samples, NOISE_DIM, noise, rand)))
    out = _to_nchw(out, dim)
    for i in (2, 3, 4):
        out = torch.relu(_deconv(p, f"Generator.{i}", out))
    return nchw_to_flat(torch.tanh(_deconv(p, "Generator.5", out)))


def multiplicative_dcgan64_generator(p, n_samples: int, rand, *, dim: int = 64,
                                     noise: torch.Tensor | None = None) -> torch.Tensor:
    out = _to_nchw(_linear(p, "Generator.Input", noise_input(n_samples, NOISE_DIM, noise, rand)), 16 * dim)
    out = _gate(_bn(p, "Generator.BN1", out))
    for i, _, _ in _UP64:
        out = _gate(_bn(p, f"Generator.BN{i}", _deconv(p, f"Generator.{i}", out)))
    return nchw_to_flat(torch.tanh(_deconv(p, "Generator.5", out)))


def dcgan64_discriminator(p, inputs: torch.Tensor, rand=None, *, dim: int = 64,
                          mode: str = "dcgan") -> tuple[torch.Tensor, torch.Tensor]:
    """``(logits [N], features [N, 16 * 8 dim])``; no dropout."""
    norm = _norm64(p, mode)
    out = leaky_relu(_conv(p, "Discriminator.1", flat_to_nchw(inputs, 3, 64, 64)))
    for i, _, _ in _DOWN64:
        out = leaky_relu(norm(f"Discriminator.BN{i}", _conv(p, f"Discriminator.{i}", out)))
    return _critic_head(p, out)


def multiplicative_dcgan64_discriminator(p, inputs: torch.Tensor, rand=None, *, dim: int = 64,
                                         mode: str = "dcgan") -> tuple[torch.Tensor, torch.Tensor]:
    norm = _norm64(p, mode)
    out = _gate(_conv(p, "Discriminator.1", flat_to_nchw(inputs, 3, 64, 64)))
    for i, _, _ in _DOWN64:
        out = _gate(norm(f"Discriminator.BN{i}", _conv(p, f"Discriminator.{i}", out)))
    return _critic_head(p, out)


# ---------------------------------------------------------------- parameters


def _batch_norms(arch: str, mode: str) -> tuple[bool, bool]:
    """Whether MNIST's or CIFAR-10's G and D have batch norms in ``mode``."""
    if arch == "mnist":
        return mode == "wgan", mode == "wgan"
    return True, mode != "wgan-CT"


def _small_params(init: ParamInit, arch: str, dim: int, mode: str) -> None:
    """MNIST (1 x 28 px) or CIFAR-10 (3 x 32 px): G, then D."""
    channels = 1 if arch == "mnist" else 3
    g_bn, d_bn = _batch_norms(arch, mode)
    init.linear("Generator.Input", NOISE_DIM, 16 * 4 * dim)
    if g_bn:
        init.norm("Generator.BN1", 16 * 4 * dim)
    for i, cin, cout in ((2, 4, 2), (3, 2, 1)):
        init.deconv(f"Generator.{i}", cin * dim, cout * dim, 5)
        if g_bn:
            init.norm(f"Generator.BN{i}", cout * dim)
    init.deconv("Generator.5", dim, channels, 5)
    d_in = channels
    for i, mult in ((1, 1), (2, 2), (3, 4)):
        init.conv(f"Discriminator.{i}", d_in, mult * dim, 5, stride=2)
        if d_bn and i > 1:
            init.norm(f"Discriminator.BN{i}", mult * dim)
        d_in = mult * dim
    init.linear("Discriminator.Output", 16 * 4 * dim, 1)


def _gen64_params(init: ParamInit, arch: str, dim: int) -> None:
    if arch == "fc":
        fc_generator_params(init)
        return
    if arch == "crippled":
        init.linear("Generator.Input", NOISE_DIM, 16 * dim)
        for i in (2, 3, 4):
            init.deconv(f"Generator.{i}", dim, dim, 5)
        init.deconv("Generator.5", dim, 3, 5)
        return
    mult = 2 if arch == "multiplicative" else 1  # the gate halves the channels
    init.linear("Generator.Input", NOISE_DIM, 16 * 8 * dim * mult)
    init.norm("Generator.BN1", 8 * dim * mult)
    for i, cin, cout in _UP64:
        init.deconv(f"Generator.{i}", cin * dim, cout * dim * mult, 5)
        init.norm(f"Generator.BN{i}", cout * dim * mult)
    init.deconv("Generator.5", dim, 3, 5)


def _disc64_params(init: ParamInit, arch: str, dim: int) -> None:
    mult = 2 if arch == "multiplicative" else 1
    init.conv("Discriminator.1", 3, dim * mult, 5, stride=2)
    for i, cin, cout in _DOWN64:
        init.conv(f"Discriminator.{i}", cin * dim, cout * dim * mult, 5, stride=2)
        init.norm(f"Discriminator.BN{i}", cout * dim * mult)  # batch or layer norm: the same names
    init.linear("Discriminator.Output", 16 * 8 * dim, 1)


def init_params(arch: str, dim: int, mode: str = "wgan-CT", seed: int = 0) -> dict[str, np.ndarray]:
    """Fresh G and D parameters of ``arch`` (one of :data:`ARCHS`) in the
    JAX layout, equal to what ``ctgan_tpu``'s ``init_context(seed)`` creates
    for its app's generator and then its discriminator (the 64 px archs'
    D: ``dcgan64_discriminator``, or the multiplicative one).  ``dcgan``'s
    G and D, and the D of ``crippled`` and ``fc``, draw under the 0.02
    override, as the JAX models build them."""
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}")
    init = ParamInit(seed)
    if arch in ("mnist", "cifar"):
        _small_params(init, arch, dim, mode)
        return init.params
    with WeightsStdevOverride(DCGAN_STDEV) if arch == "dcgan" else contextlib.nullcontext():
        _gen64_params(init, arch, dim)
    with WeightsStdevOverride(DCGAN_STDEV) if arch != "multiplicative" else contextlib.nullcontext():
        _disc64_params(init, arch, dim)
    return init.params


def zero_grad_params(arch: str, mode: str) -> list[str]:
    """Parameters whose training gradient is zero in exact arithmetic, so
    that a TF-Adam step on them (about lr * sign of rounding noise) may go
    either way in two correct runs (``train.optim.adam_mismatches``): the
    biases of the layers that feed a batch norm (which subtracts them; a
    layer norm over C, H and W does not), and in the WGAN modes the
    critic's output bias, which cancels in the WGAN and CT differences and
    which the gradient penalty does not see."""
    names = []
    if arch in ("mnist", "cifar"):
        g_bn, d_bn = _batch_norms(arch, mode)
        if g_bn:
            names += ["Generator.Input.b", "Generator.2.Biases", "Generator.3.Biases"]
        if d_bn:
            names += ["Discriminator.2.Biases", "Discriminator.3.Biases"]
    else:
        if arch in ("dcgan", "multiplicative"):
            names += [f"Generator.{i}.Biases" for i, _, _ in _UP64]
        if mode != "wgan-ct":
            names += [f"Discriminator.{i}.Biases" for i, _, _ in _DOWN64]
    if mode.lower().startswith("wgan"):
        names.append("Discriminator.Output.b")
    return names
