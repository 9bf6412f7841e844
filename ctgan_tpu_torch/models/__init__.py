"""The flagship model and the 64 px "Good" ResNet (counterpart of
``ctgan_tpu/models``)."""

from . import blocks, common, good64, resnet_cifar

__all__ = ["blocks", "common", "good64", "resnet_cifar"]
