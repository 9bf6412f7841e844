"""``ctgan_tpu_torch``'s unconditional trainer on the paper's MNIST and
CIFAR-10 conv models against ``ctgan_tpu``'s on the CPU: two iterations
substep by substep from the same state, every draw injected from the JAX
side (``check_iterations`` of tests/test_torch_gan_trainer.py: losses,
gradients read from the optimiser's moments, updated params), in
``wgan-CT`` (no batch norm in either model, TF-Adam), ``wgan`` (MNIST:
batch norm in G and D, RMSProp and the weight clip) and CIFAR's
``wgan-ct`` (batch norm in D).  MNIST at dim 8, CIFAR at dim 16; batch 4,
1 critic iteration.

Gradients are held to ``GRAD_RTOL`` of each tensor's largest, tighter than
the 1e-2 of the 64 px ResNet (whose layer and batch norms made JAX's fp32
gradients the less exact side by 2.47e-3, tests/torch_precision_probe.py):
these critics are three convs deep, and the largest deviation measured
here is 7.8e-7 (MNIST wgan-CT), 5.5e-5 (MNIST wgan, batch norm over 4 in
G and D), 2.4e-5 (CIFAR wgan-CT, batch norm in G) and 1.5e-5 (CIFAR
wgan-ct).  The other tolerances are
``check_iterations``'s."""

from __future__ import annotations

import pytest

import jax.numpy as jnp

from ctgan_tpu.models import dcgan as jax_dcgan

from ctgan_tpu_torch.models import dcgan as port_dcgan

from test_torch_gan_trainer import Net, check_iterations

GRAD_RTOL = 1e-4
DIMS = {"mnist": 8, "cifar": 16}


def dcgan_net(arch: str, mode: str) -> Net:
    dim = DIMS[arch]
    if arch == "mnist":
        jax_fns = (lambda n, noise=None: jax_dcgan.mnist_generator(n, noise, dim=dim, mode=mode),
                   lambda x: jax_dcgan.mnist_discriminator(x, dim=dim, mode=mode))
        port_fns = (lambda p, n, rand, noise=None: port_dcgan.mnist_generator(p, n, rand, dim=dim, mode=mode,
                                                                              noise=noise),
                    lambda p, x, rand: port_dcgan.mnist_discriminator(p, x, rand, dim=dim, mode=mode))
    else:
        jax_fns = (lambda n, noise=None: jax_dcgan.cifar_generator(n, noise, dim=dim),
                   lambda x: jax_dcgan.cifar_discriminator(x, dim=dim, mode=mode))
        port_fns = (lambda p, n, rand, noise=None: port_dcgan.cifar_generator(p, n, rand, dim=dim, noise=noise),
                    lambda p, x, rand: port_dcgan.cifar_discriminator(p, x, rand, dim=dim, mode=mode))

    def params(seed):
        arrays = {k: jnp.asarray(v) for k, v in port_dcgan.init_params(arch, dim, mode, seed).items()}
        return ({k: v for k, v in arrays.items() if k.startswith("Generator")},
                {k: v for k, v in arrays.items() if k.startswith("Discriminator")})

    return Net(jax_dcgan, jax_fns, port_fns, params, 784 if arch == "mnist" else 3072,
               0.0 if arch == "mnist" else -1.0, port_dcgan.zero_grad_params(arch, mode), GRAD_RTOL)


@pytest.mark.parametrize("arch,mode,extra", [
    ("mnist", "wgan-CT", {}),
    ("mnist", "wgan", {}),
    ("cifar", "wgan-CT", dict(lr_decay=True, iters=10)),
    ("cifar", "wgan-ct", {}),
])
def test_iterations_match_jax(arch, mode, extra, monkeypatch):
    check_iterations(mode, extra, monkeypatch, dcgan_net(arch, mode))

