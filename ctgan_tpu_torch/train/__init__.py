"""Trainers (the flagship's ACGAN and the unconditional GAN), optimisers,
LR schedule and the training loop (counterpart of ``ctgan_tpu/train``)."""

from .loop import LoopConfig, train_loop
from .optim import Adam, RMSProp
from .schedules import linear_decay
from .trainer_acgan import AcganConfig, AcganState, AcganTrainer
from .trainer_gan import GanConfig, GanState, GanTrainer

__all__ = [
    "Adam", "AcganConfig", "AcganState", "AcganTrainer", "GanConfig", "GanState", "GanTrainer",
    "LoopConfig", "RMSProp", "linear_decay", "train_loop",
]
