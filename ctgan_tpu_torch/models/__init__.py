"""The ported models: the flagship, the 64 px "Good" ResNet, the DCGAN family,
the fully-connected G and D and the semi-supervised classifiers (counterpart
of ``ctgan_tpu/models``)."""

from . import blocks, classifiers, common, dcgan, fc, good64, resnet_cifar

__all__ = ["blocks", "classifiers", "common", "dcgan", "fc", "good64", "resnet_cifar"]
