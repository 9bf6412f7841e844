"""The port's counterparts of ``tests/tiny_ssl.py``'s tiny semi-supervised
CIFAR-10 nets, and small data for the semi-supervised apps.

The nets keep the real apps' contract (128-d features for the ensemble
buffers, ``Classifier.``/``Generator.`` names, the data-dependent init) at a
width the CPU steps through in milliseconds: the full CIFAR-10 nets take
seconds a step here.  :func:`tiny_init_params` creates what
``tiny_ssl.apply_tiny_ssl_models``'s nets create under the JAX package's
``init_context(seed)``, in its order, so both packages start from the same
weights.  ``apply_*`` take a setter (``monkeypatch.setattr``) and patch the
port's modules, as ``tiny_ssl.py`` patches the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ctgan_tpu_torch.core.store import ParamInit
from ctgan_tpu_torch.data.synthetic import synthetic_images, synthetic_mnist
from ctgan_tpu_torch.models import classifiers
from ctgan_tpu_torch.models.classifiers import ClassifierOut, _wn, deconv_bn_relu, wn_generator_output
from ctgan_tpu_torch.ops import (
    batchnorm,
    dropout,
    global_mean_pool,
    leaky_relu,
    linear,
    wn_conv2d,
    wn_dense,
)


def tiny_classifier(p, x, rand, *, deterministic=False, init_updates=None):
    out = x.reshape(-1, 3, 32, 32) if x.ndim == 2 else x
    out = _wn(wn_conv2d, p, "Classifier.C1", out, init_updates, pad=1, stride=2, nonlinearity=leaky_relu)
    if not deterministic:
        out = dropout(out, 0.5, rand)
    out = _wn(wn_conv2d, p, "Classifier.NIN", out, init_updates, nonlinearity=leaky_relu)
    pooled = global_mean_pool(out)
    logits = _wn(wn_dense, p, "Classifier.Output", pooled, init_updates, nonlinearity=None, init_stdv=0.1)
    return ClassifierOut(logits, pooled, pooled)


def tiny_generator(p, n_samples, rand, *, noise_dim=8, noise=None, init_updates=None):
    z = noise if noise is not None else rand.uniform(n_samples, noise_dim)
    out = torch.relu(batchnorm(linear(z, p["Generator.D1.W"]), None, p["Generator.BN1.offset"]))
    out = out.reshape(-1, 8, 8, 8).permute(0, 3, 1, 2)
    out = deconv_bn_relu(p, "Generator.DC1", out)
    out = wn_generator_output(p, "Generator.Output", out, init_updates)
    return out.reshape(out.shape[0], -1)


_INIT_PARAMS = classifiers.init_params


def tiny_init_params(arch: str = "cifar", seed: int = 0) -> dict[str, np.ndarray]:
    """The tiny nets' parameters for ``"cifar"``; MNIST's nets stay the
    real ones (cheap here)."""
    if arch != "cifar":
        return _INIT_PARAMS(arch, seed)
    init = ParamInit(seed)
    init.weightnormed("Classifier.C1", (3, 3, 3, 16), 16)
    init.weightnormed("Classifier.NIN", (1, 1, 16, 128), 128)
    init.weightnormed("Classifier.Output", (128, 10), 10)
    init.linear("Generator.D1", 8, 8 * 8 * 8, biases=False)
    init.norm("Generator.BN1", 8 * 8 * 8, scale=False)
    init.deconv("Generator.DC1", 8, 8, 5, biases=False)
    init.norm("Generator.DC1.BN", 8, scale=False)
    init.weightnormed("Generator.Output", (5, 5, 3, 8), 3)
    return init.params


def apply_tiny_ssl_models(setter):
    setter(classifiers, "cifar_ssl_classifier", tiny_classifier)
    setter(classifiers, "cifar_ssl_generator", tiny_generator)
    setter(classifiers, "init_params", tiny_init_params)


def small_cifar(data_dir=None, subset="train"):
    """``tiny_ssl.apply_small_cifar``'s data: 200 train and 100 test images."""
    n = 200 if subset == "train" else 100
    flat, y = synthetic_images(n, 3, 32, seed=0 if subset == "train" else 1)
    return flat.reshape(-1, 3, 32, 32).astype("float32") / 255.0 - 0.5, y


def small_mnist(path=None, n_examples=None):
    """``test_apps._small_mnist``'s data: 500 train, 100 dev, 200 test."""
    tr, dev, te = synthetic_mnist(500, 100, 200)
    return {"train": tr, "dev": dev, "test": te}


def apply_small_data(setter):
    import ctgan_tpu_torch.data.cifar10 as cifar_mod
    import ctgan_tpu_torch.data.mnist as mnist_mod

    setter(cifar_mod, "load_normalized", small_cifar)
    setter(mnist_mod, "load_arrays", small_mnist)
