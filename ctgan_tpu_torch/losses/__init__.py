"""GAN losses (counterpart of ``ctgan_tpu/losses``)."""

from .gan import (
    acgan_accuracy,
    acgan_loss,
    consistency_term,
    dcgan_losses,
    gradient_penalty,
    lsgan_losses,
    wgan_losses,
)

__all__ = [
    "acgan_accuracy", "acgan_loss", "consistency_term", "dcgan_losses", "gradient_penalty",
    "lsgan_losses", "wgan_losses",
]
