"""Semi-supervised CT classifier on 4,000-label CIFAR-10, with temporal
ensembling as an option (counterpart of ``ctgan_tpu/apps/ct_cifar_ssl.py``;
``CT_CIFAR.py`` and ``CT_CIFAR-10_TE.py``).

    python -m ctgan_tpu_torch.apps.ct_cifar_ssl --epochs 2 --out_dir runs/x
    python -m ctgan_tpu_torch.apps.ct_cifar_ssl --temporal_ensembling true ...

The flags are the fields of :class:`Config`, under the JAX app's names and
defaults: ``count`` 400 labels per class, batch 100, lr 3e-4, 1,000
epochs, seeds 2; with ``temporal_ensembling`` the consistency term compares
one pass with per-example EMA targets (decay ``prediction_decay`` 0.6,
weight ``LAMBDA_2`` 1.0) instead of a second pass.  The classifier
(``models.classifiers.cifar_ssl_classifier``) drops out at keep 0.8 on its
input and 0.5 after C3 and C6 through the CUDA mask kernel, fp32 (the JAX
app never sets bf16): 18 launches per step (6 passes x 3), 15 with
temporal ensembling (5 x 3), 3 at the data-dependent init (batch 500),
none at test.

Data: ``data.cifar10.load_normalized`` (batch files in ``data_dir``, else
the synthetic set), [-0.5, 0.5] NCHW, on the device.  Each step crops and
flips its three batches there (``data.augment.random_crop_flip``: 2 px
reflect pad, offsets in [0, 4]); the reference did it in a host loop per
image.  The JAX app's dispatch modes: ``chunk`` K logs the mean of the means
of chunks of K batches, a ragged last chunk dropped; ``epoch_scan`` runs
every batch and logs the mean over the steps.  On the card each step is
one replay of a CUDA graph.  Checkpoints, logs and resume (the ensemble
buffers too, their bias correction counting from ``ens_base``):
``apps.ssl_common``.

Entry points run on ``cuda``; ``main(..., device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..data import cifar10
from ..models import classifiers
from . import common, ssl_common
from .common import require_device, setup_out_dir

__all__ = ["Config", "main", "parse_config", "setup"]


@dataclass(frozen=True)
class Config:
    seed: int = 2
    seed_data: int = 2
    count: int = 400             # labels per class: 4,000
    batch_size: int = 100
    unlabeled_weight: float = 1.0
    learning_rate: float = 3e-4
    epochs: int = 1000
    data_dir: str = ""
    temporal_ensembling: bool = False
    prediction_decay: float = 0.6
    LAMBDA_2: float = 1.0        # the TE variant's CT weight; the plain one uses fixed weights
    factor_M: float = 0.0
    allow_fresh_start: bool = False
    chunk: int = 1               # batches per logged chunk mean; a ragged last chunk is dropped
    epoch_scan: bool = False     # every batch as one range: the steps' mean, read once an epoch
    out_dir: str = "runs/ct_cifar_ssl"


def parse_config(argv=None) -> Config:
    return common.parse_config(Config, argv)


def setup(cfg: Config, device) -> ssl_common.SslApp:
    """A fresh run of ``cfg`` on ``device``, its data on the device."""
    train = cifar10.load_normalized(cfg.data_dir or None, "train")
    test = cifar10.load_normalized(cfg.data_dir or None, "test")
    return ssl_common.build(cfg, "cifar", classifiers.cifar_ssl_classifier, classifiers.cifar_ssl_generator,
                            classifiers.init_params, train, test, device,
                            variant="te" if cfg.temporal_ensembling else "cifar", lambda_2=cfg.LAMBDA_2,
                            augment=True)


def main(argv=None, cfg: Config | None = None, device="cuda"):
    """Train to ``cfg.epochs`` on ``device``, resuming from ``out_dir``
    when it holds a run.  Returns the final state and the records logged by
    this process."""
    cfg = cfg or parse_config(argv)
    device = require_device(device)
    out_dir = setup_out_dir(cfg)
    app = setup(cfg, device)
    print(f"device {device}, out_dir {out_dir}")
    return ssl_common.run(cfg, app, out_dir, device, name="ct_cifar_ssl", ensemble=True,
                          temporal_ensembling=cfg.temporal_ensembling, prediction_decay=cfg.prediction_decay)


if __name__ == "__main__":
    main()
