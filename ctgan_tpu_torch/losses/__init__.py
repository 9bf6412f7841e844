"""GAN and semi-supervised classifier losses (counterpart of ``ctgan_tpu/losses``)."""

from .gan import (
    acgan_accuracy,
    acgan_loss,
    consistency_term,
    dcgan_losses,
    gradient_penalty,
    input_slopes,
    lsgan_losses,
    wgan_losses,
)
from .semisup import (
    classification_error,
    ct_cifar_unlabeled_loss,
    ct_mnist_unlabeled_loss,
    ct_te_unlabeled_loss,
    ema_targets_update,
    feature_matching_abs,
    feature_matching_sq,
    labeled_loss,
)

__all__ = [
    "acgan_accuracy", "acgan_loss", "consistency_term", "dcgan_losses", "gradient_penalty",
    "input_slopes", "lsgan_losses", "wgan_losses", "classification_error", "ct_cifar_unlabeled_loss",
    "ct_mnist_unlabeled_loss", "ct_te_unlabeled_loss", "ema_targets_update", "feature_matching_abs",
    "feature_matching_sq", "labeled_loss",
]
