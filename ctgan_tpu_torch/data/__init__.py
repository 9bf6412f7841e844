"""Data for the flagship (counterpart of ``ctgan_tpu/data``)."""

from .cifar10 import load_arrays, load_train
from .iterator import DeviceSampler
from .synthetic import synthetic_cifar10, synthetic_images

__all__ = ["DeviceSampler", "load_arrays", "load_train", "synthetic_cifar10", "synthetic_images"]
