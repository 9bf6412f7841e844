"""The ported models: the flagship, the 64 px "Good" ResNet, the DCGAN family
and the fully-connected G and D (counterpart of ``ctgan_tpu/models``)."""

from . import blocks, common, dcgan, fc, good64, resnet_cifar

__all__ = ["blocks", "common", "dcgan", "fc", "good64", "resnet_cifar"]
