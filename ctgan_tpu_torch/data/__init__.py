"""Data of the flagship and the 64 px app (counterpart of ``ctgan_tpu/data``)."""

from .augment import random_flip, scale_and_flip
from .cifar10 import load_arrays, load_train
from .iterator import DeviceSampler
from .synthetic import synthetic_cifar10, synthetic_images

__all__ = [
    "DeviceSampler", "load_arrays", "load_train", "random_flip", "scale_and_flip",
    "synthetic_cifar10", "synthetic_images",
]
