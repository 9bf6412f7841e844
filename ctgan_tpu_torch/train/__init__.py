"""Flagship trainer, TF-Adam and LR schedule (counterpart of ``ctgan_tpu/train``)."""

from .optim import Adam
from .schedules import linear_decay
from .trainer_acgan import AcganConfig, AcganState, AcganTrainer

__all__ = ["Adam", "AcganConfig", "AcganState", "AcganTrainer", "linear_decay"]
