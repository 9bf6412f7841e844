"""Data of the ported apps (counterpart of ``ctgan_tpu/data``): CIFAR-10,
MNIST, the 64 px synthetic pool and the device-resident sampler."""

from . import mnist
from .augment import random_flip, scale_and_flip
from .cifar10 import load_arrays, load_train
from .iterator import DeviceSampler, EpochIterator
from .synthetic import synthetic_cifar10, synthetic_images, synthetic_mnist

__all__ = [
    "DeviceSampler", "EpochIterator", "load_arrays", "load_train", "mnist", "random_flip",
    "scale_and_flip", "synthetic_cifar10", "synthetic_images", "synthetic_mnist",
]
