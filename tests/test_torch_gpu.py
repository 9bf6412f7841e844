"""Tests of ``ctgan_tpu_torch`` that need an NVIDIA card (marked ``gpu``;
they skip without one).  On the card:

    python -m pytest -m gpu tests/test_torch_gpu.py

No JAX here, so the file collects where JAX is not installed."""

from __future__ import annotations

import math

import pytest
import torch

from ctgan_tpu_torch.core import Randomness, precision_policy
from ctgan_tpu_torch.kernels import (
    dropout_mask,
    dropout_mask_reference,
    philox_uniform,
    philox_uniform_reference,
)
from ctgan_tpu_torch.models import resnet_cifar
from ctgan_tpu_torch.ops import dropout
from ctgan_tpu_torch.train import AcganConfig, AcganTrainer
from ctgan_tpu_torch.bridge import from_jax_params
from ctgan_tpu_torch.core import split_params

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(128, 128, 8, 8), (256, 128, 8, 8), (64, 128, 8, 8), (1001,), (3, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kp", [0.8, 0.5])
def test_kernel_equals_plain_version(cuda, shape, dtype, kp):
    before = dropout_mask.launches
    got = dropout_mask(2024, shape, kp, dtype, cuda)
    torch.cuda.synchronize()
    assert dropout_mask.launches == before + 1
    assert got.shape == shape and got.dtype == dtype and got.is_cuda
    assert torch.equal(got, dropout_mask_reference(2024, shape, kp, dtype, cuda))
    assert torch.equal(got.cpu(), dropout_mask_reference(2024, shape, kp, dtype, "cpu"))


def test_kernel_keep_fraction_and_seeds(cuda):
    shape, kp = (256, 128, 8, 8), 0.8
    a = dropout_mask(1, shape, kp, device=cuda)
    b = dropout_mask(1, shape, kp, device=cuda)
    c = dropout_mask(2, shape, kp, device=cuda)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and not torch.equal(a, c)
    n = a.numel()
    assert abs(float((a != 0).float().mean()) - kp) < 5 * math.sqrt(kp * (1 - kp) / n)


def test_dropout_derivatives_on_the_card(cuda):
    x = torch.randn(64, 128, 8, 8, device=cuda, requires_grad=True)
    mask = Randomness(3, cuda).dropout_mask(tuple(x.shape), 0.5, x.dtype, cuda)

    def derivs(fn):
        (g,) = torch.autograd.grad(torch.tanh(fn(x)).square().sum(), x, create_graph=True)
        (gg,) = torch.autograd.grad(g.square().sum(), x)
        return g.detach(), gg

    for a, b in zip(derivs(lambda v: dropout(v, 0.5, Randomness(3, cuda))), derivs(lambda v: v * mask)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(64, 3072), (640, 3072), (1001,), (3, 5)])
def test_uniform_kernel_equals_plain_version(cuda, shape):
    before = philox_uniform.launches
    got = philox_uniform(77, shape, 1 / 128, cuda)
    torch.cuda.synchronize()
    assert philox_uniform.launches == before + 1
    assert got.shape == shape and got.dtype == torch.float32 and got.is_cuda
    assert torch.equal(got.cpu(), philox_uniform_reference(77, shape, 1 / 128))


@pytest.mark.parametrize("step", [0, 1, 781])
def test_draws_on_the_card_equal_the_cpu(cuda, step):
    draws = []
    for device in (cuda, torch.device("cpu")):
        r = Randomness(11, device).for_step(step)
        draws.append([r.noise(128, 128), r.labels(128, 10), r.dequant((64, 3072)), r.gp_alpha(64),
                      r.dropout_mask((64, 128, 8, 8), 0.5, torch.bfloat16, device)])
    for got, want in zip(*draws):
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


def test_trainer_step_on_the_card_goes_through_the_kernel(cuda):
    dim, batch, n_critic = 16, 4, 2
    mcfg = resnet_cifar.ResnetCifarConfig(dim_g=dim, dim_d=dim)
    trainer = AcganTrainer(
        lambda p, n, labels, rand, noise=None: resnet_cifar.generator(p, n, labels, mcfg, rand, noise=noise),
        lambda p, x, labels, kps, rand: resnet_cifar.discriminator(p, x, labels, kps, mcfg, rand),
        AcganConfig(batch_size=batch, critic_iters=n_critic),
    )
    params = {k: v.to(cuda) for k, v in from_jax_params(resnet_cifar.init_params(mcfg, 0)).items()}
    gen, disc, _ = split_params(params, "Generator", "Discriminator")
    state = trainer.init_state(gen, disc)
    real = torch.randint(0, 256, (n_critic, batch, 3072), dtype=torch.uint8, device=cuda)
    labels = torch.randint(0, 10, (n_critic, batch), device=cuda)
    for policy in ("float32", "bfloat16"):
        before, uniforms = dropout_mask.launches, philox_uniform.launches
        with precision_policy(policy):
            metrics = trainer.step(state, real, labels, Randomness(0, cuda))
        assert dropout_mask.launches - before == 3 + 6 * n_critic
        assert philox_uniform.launches - uniforms == n_critic
        assert all(math.isfinite(float(v)) for v in metrics.values())
