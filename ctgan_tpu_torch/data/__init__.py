"""Data of the ported apps (counterpart of ``ctgan_tpu/data``): CIFAR-10,
MNIST, the 64 px synthetic pool, augmentation and the device-resident
sampler."""

from . import cifar10, mnist
from .augment import random_crop_flip, random_flip, scale_and_flip, two_stream_augment
from .cifar10 import load_arrays, load_normalized, load_train
from .iterator import DeviceSampler, EpochIterator
from .synthetic import synthetic_cifar10, synthetic_images, synthetic_mnist

__all__ = [
    "DeviceSampler", "EpochIterator", "cifar10", "load_arrays", "load_normalized", "load_train", "mnist",
    "random_crop_flip", "random_flip", "scale_and_flip", "synthetic_cifar10", "synthetic_images",
    "synthetic_mnist", "two_stream_augment",
]
