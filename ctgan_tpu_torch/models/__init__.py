"""The flagship model (counterpart of ``ctgan_tpu/models``)."""

from . import blocks, common, resnet_cifar

__all__ = ["blocks", "common", "resnet_cifar"]
