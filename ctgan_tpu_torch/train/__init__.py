"""Flagship trainer, TF-Adam, LR schedule and the training loop (counterpart
of ``ctgan_tpu/train``)."""

from .loop import LoopConfig, train_loop
from .optim import Adam
from .schedules import linear_decay
from .trainer_acgan import AcganConfig, AcganState, AcganTrainer

__all__ = [
    "Adam", "AcganConfig", "AcganState", "AcganTrainer", "LoopConfig", "linear_decay", "train_loop",
]
