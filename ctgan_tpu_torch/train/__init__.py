"""Trainers (the flagship's ACGAN, the unconditional GAN and the
semi-supervised classifier), optimisers, LR schedule, the data-dependent
weight-norm init, D's recomputation (``remat``), batch-norm
recalibration and the training loop (counterpart of ``ctgan_tpu/train``)."""

from .loop import LoopConfig, train_loop
from .optim import Adam, AdamTheano, Adamax, Momentum, Nadam, RMSProp, Sgd, with_state_dtype
from .recalibrate import recalibrate_bn
from .remat import make_remat_disc
from .schedules import linear_decay
from .trainer_acgan import AcganConfig, AcganState, AcganTrainer
from .trainer_gan import GanConfig, GanState, GanTrainer
from .trainer_semisup import SslConfig, SslState, SslTrainer, make_ssl_trainer
from .wn_init import data_dependent_init

__all__ = [
    "Adam", "AcganConfig", "AcganState", "AcganTrainer", "AdamTheano", "Adamax", "GanConfig", "GanState",
    "GanTrainer", "LoopConfig", "Momentum", "Nadam", "RMSProp", "Sgd", "SslConfig", "SslState", "SslTrainer",
    "data_dependent_init", "linear_decay", "make_remat_disc", "make_ssl_trainer", "recalibrate_bn", "train_loop",
    "with_state_dtype",
]
