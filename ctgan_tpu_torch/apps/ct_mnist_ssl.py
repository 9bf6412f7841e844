"""Semi-supervised CT classifier on 100-label MNIST (counterpart of
``ctgan_tpu/apps/ct_mnist_ssl.py``; ``CT_MNIST.py``).

    python -m ctgan_tpu_torch.apps.ct_mnist_ssl --epochs 2 --out_dir runs/x

The flags are the fields of :class:`Config`, under the JAX app's names and
defaults: ``count`` 10 labels per class, batch 100, lr 3e-3, ``LAMBDA_2``
0.1, 300 epochs, seeds 2.  A feature-matching GAN classifier
(``models.classifiers.mnist_ssl_classifier``, Gaussian noise between its
weight-normed dense layers, and ``mnist_ssl_generator``) with the
consistency term between two noisy passes, parameters averaged for test,
data-dependent init on the first 500 training images.  fp32 (the JAX app
never sets bf16); no dropout, so no kernel on this path.

Data: ``data.mnist`` train and dev, 60,000 images, as the unlabelled set and
the pool the labels are chosen from (``select_labeled``); test, 10,000.
The JAX app logs the means of chunks of 50 batches; 50 divides the 600
batches of an epoch, so the mean over the steps that the port logs is the
same.  ``epoch_scan`` runs the JAX app's one-program epoch: every batch, the
mean over the steps read once (``apps.ssl_common``).  On the
card each step is one replay of a CUDA graph.  Checkpoints, logs and
resume: ``apps.ssl_common``.

Entry points run on ``cuda``; ``main(..., device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..data import mnist
from ..models import classifiers
from . import common, ssl_common
from .common import require_device, setup_out_dir

__all__ = ["Config", "main", "parse_config", "setup"]


@dataclass(frozen=True)
class Config:
    seed: int = 2
    seed_data: int = 2
    unlabeled_weight: float = 1.0
    batch_size: int = 100
    count: int = 10              # labels per class
    epochs: int = 300
    learning_rate: float = 0.003
    LAMBDA_2: float = 0.1
    factor_M: float = 0.0
    allow_fresh_start: bool = False
    epoch_scan: bool = False     # the JAX dispatch mode: every batch, the steps' mean read once an epoch
    out_dir: str = "runs/ct_mnist_ssl"


def parse_config(argv=None) -> Config:
    return common.parse_config(Config, argv)


def setup(cfg: Config, device) -> ssl_common.SslApp:
    """A fresh run of ``cfg`` on ``device``, its data on the device."""
    d = mnist.load_arrays()
    train = (np.concatenate([d["train"][0], d["dev"][0]]), np.concatenate([d["train"][1], d["dev"][1]]))
    return ssl_common.build(cfg, "mnist", classifiers.mnist_ssl_classifier, classifiers.mnist_ssl_generator,
                            classifiers.init_params, train, d["test"], device, variant="mnist",
                            lambda_2=cfg.LAMBDA_2, augment=False)


def main(argv=None, cfg: Config | None = None, device="cuda"):
    """Train to ``cfg.epochs`` on ``device``, resuming from ``out_dir``
    when it holds a run.  Returns the final state and the records logged by
    this process."""
    cfg = cfg or parse_config(argv)
    device = require_device(device)
    out_dir = setup_out_dir(cfg)
    app = setup(cfg, device)
    print(f"device {device}, out_dir {out_dir}")
    return ssl_common.run(cfg, app, out_dir, device, name="ct_mnist_ssl")


if __name__ == "__main__":
    main()
