"""Data of the ported apps (counterpart of ``ctgan_tpu/data``): CIFAR-10,
MNIST, the synthetic pools, augmentation, the device-resident sampler, the
image-directory reader and the native host pipeline."""

from . import cifar10, images_dir, mnist, native
from .augment import random_crop_flip, random_flip, scale_and_flip, two_stream_augment
from .cifar10 import load_arrays, load_normalized, load_train
from .iterator import DeviceSampler, EpochIterator, stack_batches
from .synthetic import synthetic_cifar10, synthetic_images, synthetic_mnist

__all__ = [
    "DeviceSampler", "EpochIterator", "cifar10", "images_dir", "load_arrays", "load_normalized", "load_train",
    "mnist", "native", "random_crop_flip", "random_flip", "scale_and_flip", "stack_batches",
    "synthetic_cifar10", "synthetic_images", "synthetic_mnist", "two_stream_augment",
]
