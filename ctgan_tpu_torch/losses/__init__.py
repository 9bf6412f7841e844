"""GAN losses (counterpart of ``ctgan_tpu/losses``)."""

from .gan import acgan_accuracy, acgan_loss, consistency_term, gradient_penalty, wgan_losses

__all__ = ["acgan_accuracy", "acgan_loss", "consistency_term", "gradient_penalty", "wgan_losses"]
