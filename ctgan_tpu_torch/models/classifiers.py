"""The semi-supervised GAN classifiers and their generators (counterpart of
``ctgan_tpu/models/classifiers.py``; ``CT_MNIST.py:32-53`` and
``CT_CIFAR.py:69-93`` of the reference).  NCHW.

* MNIST classifier: Gaussian noise (sigma 0.3 on the input, 0.5 after each
  hidden layer), five weight-normed ReLU dense layers (1000, 500, 250, 250,
  250) and a weight-normed 10-way output.  ``features`` is the noisy last
  hidden layer (the CT's), ``fm_features`` the clean one (G's feature
  matching).  Its generator: two bias-free dense layers with batch norm
  (offset, no gain) and softplus, then an L2-normalised sigmoid output.
* CIFAR-10 classifier: dropout at keep 0.8 on the input, nine weight-normed
  3x3 leaky-ReLU convs with pad 1 (stride 2 at C3 and C6, dropout at keep
  0.5 after each), C7 ``VALID``, two 1x1 NIN layers, a global mean pool
  (``features`` and ``fm_features``, 128-d) and a weight-normed 10-way
  output.  Its generator: a bias-free dense layer to ``[4, 4, 512]`` (read
  as the JAX model's NHWC), batch norm and ReLU, two 5x5 transposed convs
  with batch norm and ReLU, then a weight-normed tanh transposed conv.

Classifiers take their parameters with each weight-normed layer's applied
weight added (:func:`with_applied_weights`, once for all the passes of a
loss: they share it) and flat channel-major images or NCHW batches, and
return a :class:`ClassifierOut`; ``deterministic`` passes draw nothing.
With an ``init_updates`` dict the pass is the data-dependent init
(``ops.weightnorm``): each weight-normed layer writes its new ``.g`` and
``.b`` there.  Generators, one pass a loss, take the plain parameters, draw
a uniform latent (``rand.uniform``) and return flat channel-major images.
Every draw comes from ``rand``, in the JAX model's call order.

:func:`init_params` creates an architecture's classifier and then its
generator parameters in the JAX package's order and layouts, from the same
NumPy stream, so a seed gives JAX's weights bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.store import ParamInit
from ..ops import (
    applied_weight,
    batchnorm,
    deconv2d,
    dropout,
    gaussian_noise,
    global_mean_pool,
    l2_dense,
    leaky_relu,
    linear,
    softplus,
    wn_conv2d,
    wn_deconv2d,
    wn_dense,
)
from .common import flat_to_nchw, nchw_to_flat

__all__ = [
    "ARCHS", "ClassifierOut", "cifar_ssl_classifier", "cifar_ssl_generator", "deconv_bn_relu", "init_params",
    "mnist_ssl_classifier", "mnist_ssl_generator", "with_applied_weights", "wn_generator_output",
]

ARCHS = ("mnist", "cifar")
MNIST_HIDDEN = (1000, 500, 250, 250, 250)
# CIFAR-10 classifier: (name, in, out, filter, stride, pad)
CIFAR_CONVS = (
    ("C1", 3, 128, 3, 1, 1), ("C2", 128, 128, 3, 1, 1), ("C3", 128, 128, 3, 2, 1),
    ("C4", 128, 256, 3, 1, 1), ("C5", 256, 256, 3, 1, 1), ("C6", 256, 256, 3, 2, 1),
    ("C7", 256, 512, 3, 1, "VALID"), ("NIN1", 512, 256, 1, 1, "SAME"), ("NIN2", 256, 128, 1, 1, "SAME"),
)
CIFAR_DROPOUT_AFTER = {"C3": 0.5, "C6": 0.5}


class ClassifierOut(NamedTuple):
    logits: torch.Tensor        # [N, 10], pre-softmax
    features: torch.Tensor      # the CT feature term's layer
    fm_features: torch.Tensor   # G's feature-matching layer


def _recorder(init_updates: dict | None, name: str):
    """``on_init`` of a weight-normed layer: its new ``g`` and ``b`` into
    ``init_updates`` (None outside the data-dependent init)."""
    if init_updates is None:
        return None

    def record(g: torch.Tensor, b: torch.Tensor) -> None:
        init_updates[name + ".g"] = g.detach()
        init_updates[name + ".b"] = b.detach()

    return record


APPLIED = ".W_applied"


def with_applied_weights(p: dict) -> dict:
    """``p`` and, for each of a classifier's weight-normed layers (dense or
    conv: the output axis first), its applied weight ``g * W / ||W||`` under
    ``<name>.W_applied``; the gradient flows back to ``W`` and ``g``."""
    out = dict(p)
    for key in p:
        if key.startswith("Classifier.") and key.endswith(".g"):
            name = key[:-2]
            out[name + APPLIED] = applied_weight(p[name + ".W"], p[key])
    return out


def _wn(op, p, name: str, x: torch.Tensor, init_updates: dict | None, **kw) -> torch.Tensor:
    """The classifier's weight-normed layer ``name``, from its applied
    weight (:func:`with_applied_weights`)."""
    return op(x, p[name + APPLIED], p[name + ".g"], p[name + ".b"], on_init=_recorder(init_updates, name), **kw)


def wn_generator_output(p, name: str, x: torch.Tensor, init_updates: dict | None = None) -> torch.Tensor:
    """A generator's weight-normed 5x5 tanh output ``name``, normalised in
    the call."""
    w = applied_weight(p[name + ".W"], p[name + ".g"], 1)
    return wn_deconv2d(x, w, p[name + ".g"], p[name + ".b"], nonlinearity=torch.tanh, init_stdv=0.1,
                       on_init=_recorder(init_updates, name))


# ---------------------------------------------------------------- MNIST


def mnist_ssl_classifier(p, x: torch.Tensor, rand, *, deterministic: bool = False,
                         init_updates: dict | None = None) -> ClassifierOut:
    def noise(t, sigma):
        return gaussian_noise(t, sigma, rand, deterministic=deterministic)

    out = noise(x, 0.3)
    for i in range(1, 5):
        out = noise(_wn(wn_dense, p, f"Classifier.D{i}", out, init_updates), 0.5)
    fm = _wn(wn_dense, p, "Classifier.D5", out, init_updates)
    noisy = noise(fm, 0.5)
    logits = _wn(wn_dense, p, "Classifier.Output", noisy, init_updates, nonlinearity=None)
    return ClassifierOut(logits, noisy, fm)


def mnist_ssl_generator(p, n_samples: int, rand, *, noise_dim: int = 100,
                        noise: torch.Tensor | None = None) -> torch.Tensor:
    """Flat ``[n, 784]`` images in (0, 1)."""
    z = noise if noise is not None else rand.uniform(n_samples, noise_dim)
    out = softplus(batchnorm(linear(z, p["Generator.D1.W"]), None, p["Generator.BN1.offset"]))
    out = softplus(batchnorm(linear(out, p["Generator.D2.W"]), None, p["Generator.BN2.offset"]))
    return l2_dense(out, p["Generator.Output.W"], nonlinearity=torch.sigmoid)


# ---------------------------------------------------------------- CIFAR-10


def cifar_ssl_classifier(p, x: torch.Tensor, rand, *, deterministic: bool = False,
                         init_updates: dict | None = None) -> ClassifierOut:
    """``x``: flat ``[N, 3072]`` channel-major or NCHW ``[N, 3, 32, 32]``."""
    out = flat_to_nchw(x, 3, 32, 32) if x.ndim == 2 else x
    if not deterministic:
        out = dropout(out, 0.8, rand)
    for name, _, _, _, stride, pad in CIFAR_CONVS:
        out = _wn(wn_conv2d, p, f"Classifier.{name}", out, init_updates, stride=stride, pad=pad,
                  nonlinearity=leaky_relu)
        if name in CIFAR_DROPOUT_AFTER and not deterministic:
            out = dropout(out, CIFAR_DROPOUT_AFTER[name], rand)
    pooled = global_mean_pool(out)
    logits = _wn(wn_dense, p, "Classifier.Output", pooled, init_updates, nonlinearity=None, init_stdv=0.1)
    return ClassifierOut(logits, pooled, pooled)


def deconv_bn_relu(p, name: str, x: torch.Tensor) -> torch.Tensor:
    """A bias-free 5x5 stride-2 transposed conv, batch norm without gain,
    ReLU."""
    return torch.relu(batchnorm(deconv2d(x, p[name + ".Filters"]), None, p[name + ".BN.offset"]))


def cifar_ssl_generator(p, n_samples: int, rand, *, noise_dim: int = 50, noise: torch.Tensor | None = None,
                        init_updates: dict | None = None) -> torch.Tensor:
    """Flat ``[n, 3072]`` channel-major images in [-1, 1]."""
    z = noise if noise is not None else rand.uniform(n_samples, noise_dim)
    out = torch.relu(batchnorm(linear(z, p["Generator.D1.W"]), None, p["Generator.BN1.offset"]))
    out = out.reshape(-1, 4, 4, 512).permute(0, 3, 1, 2)
    out = deconv_bn_relu(p, "Generator.DC1", out)
    out = deconv_bn_relu(p, "Generator.DC2", out)
    return nchw_to_flat(wn_generator_output(p, "Generator.Output", out, init_updates))


# ---------------------------------------------------------------- parameters


def _mnist_params(init: ParamInit) -> None:
    dims = (28 * 28, *MNIST_HIDDEN)
    for i, (cin, cout) in enumerate(zip(dims, dims[1:]), start=1):
        init.weightnormed(f"Classifier.D{i}", (cin, cout), cout, 0.1)
    init.weightnormed("Classifier.Output", (250, 10), 10, 0.1)
    init.linear("Generator.D1", 100, 500, biases=False)
    init.norm("Generator.BN1", 500, scale=False)
    init.linear("Generator.D2", 500, 500, biases=False)
    init.norm("Generator.BN2", 500, scale=False)
    init.weightnormed("Generator.Output", (500, 28 * 28), 28 * 28, g_and_b=False)


def _cifar_params(init: ParamInit) -> None:
    for name, cin, cout, k, _, _ in CIFAR_CONVS:
        init.weightnormed(f"Classifier.{name}", (k, k, cin, cout), cout)
    init.weightnormed("Classifier.Output", (128, 10), 10)
    init.linear("Generator.D1", 50, 4 * 4 * 512, biases=False)
    init.norm("Generator.BN1", 4 * 4 * 512, scale=False)
    for name, cin, cout in (("DC1", 512, 256), ("DC2", 256, 128)):
        init.deconv(f"Generator.{name}", cin, cout, 5, biases=False)
        init.norm(f"Generator.{name}.BN", cout, scale=False)
    init.weightnormed("Generator.Output", (5, 5, 3, 128), 3)


def init_params(arch: str, seed: int = 0) -> dict[str, np.ndarray]:
    """Fresh classifier and generator parameters of ``arch`` (``"mnist"``
    or ``"cifar"``) in the JAX layout, equal to what the JAX app's
    ``init_context(seed)`` creates."""
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}")
    init = ParamInit(seed)
    (_mnist_params if arch == "mnist" else _cifar_params)(init)
    return init.params
