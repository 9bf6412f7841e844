"""Tests of ``ctgan_tpu_torch`` that need an NVIDIA card (marked ``gpu``;
they skip without one).  On the card:

    python -m pytest -m gpu tests/test_torch_gpu.py

No JAX here, so the file collects where JAX is not installed."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from ctgan_tpu_torch.core import Randomness, precision_policy
from ctgan_tpu_torch.kernels import (
    dropout_mask,
    dropout_mask_reference,
    philox_uniform,
    philox_uniform_reference,
    seed_table,
)
from ctgan_tpu_torch.apps import ct_gan_64x64 as app64
from ctgan_tpu_torch.models import resnet_cifar
from ctgan_tpu_torch.ops import batchnorm, dropout
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


SEEDS = [2024, 0xFFFFFFFF, 7]
MAIN_PATH_MASKS = [(128, 128, 8, 8), (256, 128, 8, 8), (64, 128, 8, 8), (2560, 128, 8, 8), (640, 128, 8, 8)]


@pytest.mark.parametrize("shape", MAIN_PATH_MASKS + [(1001,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_table_kernel_equals_plain_version(cuda, shape, dtype):
    """The mask read from a device seed table at each slot is the plain
    version of the seed that slot holds."""
    table = seed_table(SEEDS, cuda)
    for slot, value in enumerate(SEEDS):
        got = dropout_mask(table, shape, 0.5, dtype, cuda, slot=slot)
        torch.cuda.synchronize()
        assert torch.equal(got, dropout_mask_reference(value, shape, 0.5, dtype, cuda))


@pytest.mark.parametrize("shape", [(64, 3072), (640, 3072), (1001,)])
def test_table_uniform_kernel_equals_plain_version(cuda, shape):
    table = seed_table(SEEDS, cuda)
    for slot, value in enumerate(SEEDS):
        got = philox_uniform(table, shape, 1 / 128, cuda, slot=slot)
        torch.cuda.synchronize()
        assert torch.equal(got, philox_uniform_reference(value, shape, 1 / 128, cuda))


def test_table_on_another_device_raises(cuda):
    with pytest.raises(ValueError, match="seed table"):
        dropout_mask(seed_table(SEEDS), (64, 128), 0.5, torch.float32, cuda)
    with pytest.raises(IndexError):
        philox_uniform(seed_table(SEEDS, cuda), (64, 128), 1.0, cuda, slot=len(SEEDS))


def _draws(provider, device):
    """Masks in both dtypes and dequantisation noise, in one order."""
    return [provider.dropout_mask((64, 128, 8, 8), 0.8, torch.bfloat16, device), provider.dequant((64, 3072)),
            provider.dropout_mask((256, 128, 8, 8), 0.5, torch.bfloat16, device),
            provider.dropout_mask((64, 128, 8, 8), 0.5, torch.float32, device)]


class _Slots:
    def __init__(self, seeds):
        self.seeds, self.slot = seeds, -1

    def dropout_mask(self, shape, kp, dtype, device):
        self.slot += 1
        return dropout_mask(self.seeds, shape, kp, dtype, device, slot=self.slot)

    def dequant(self, shape):
        self.slot += 1
        return philox_uniform(self.seeds, shape, 1 / 128, self.seeds.device, slot=self.slot)


def test_captured_draws_replay_the_eager_ones(cuda):
    """A CUDA graph of the kernels against a static seed table draws, after
    each step's table is copied in, what that step's provider draws."""
    static = torch.zeros(8, dtype=torch.int32, device=cuda)
    _draws(_Slots(static), cuda)  # loads the kernels before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _draws(_Slots(static), cuda)
    replayed = []
    for step in (0, 1):
        rand = Randomness(5, cuda).for_step(step)
        eager = _draws(rand, cuda)
        static.copy_(rand.seeds[:8])
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(c, e) for c, e in zip(captured, eager))
        replayed.append([c.clone() for c in captured])
    assert not any(torch.equal(a, b) for a, b in zip(*replayed))


GOOD64_MASKS = [(64, 256, 16, 16), (64, 512, 8, 8), (64, 512, 4, 4)]


@pytest.mark.parametrize("shape,kp", zip(GOOD64_MASKS, (0.8, 0.5, 0.5)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_equals_plain_version_at_the_64px_shapes(cuda, shape, kp, dtype):
    table = seed_table(SEEDS, cuda)
    for slot, value in enumerate(SEEDS):
        got = dropout_mask(table, shape, kp, dtype, cuda, slot=slot)
        torch.cuda.synchronize()
        assert torch.equal(got, dropout_mask_reference(value, shape, kp, dtype, cuda))


def test_batchnorm_on_the_card_keeps_its_digits(cuda):
    """Channels whose mean is large against their spread: the card's batch
    norm within 1e-5 of float64, as the CPU's written-out two-pass form is
    (PyTorch's CPU kernel is not; ``ops/norm.py``)."""
    x = 100.0 + torch.randn(4, 8, 16, 16, dtype=torch.float64)
    scale, offset = torch.rand(8, dtype=torch.float64) + 0.5, torch.randn(8, dtype=torch.float64)
    want = batchnorm(x, scale, offset)
    for device in (cuda, torch.device("cpu")):
        got = batchnorm(x.float().to(device), scale.float().to(device), offset.float().to(device))
        assert float((got.double().cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_64px_step_on_the_card_goes_through_the_kernel(cuda):
    """One iteration of the 64 px app's step at dim 8 (5 critic
    substeps, wgan-ct): 63 mask launches, no uniform draws; finite metrics,
    in fp32 and bf16."""
    pool = (np.random.default_rng(0).integers(0, 256, (64, 12288), dtype=np.uint8), np.zeros(64, np.int64))
    run = app64.setup(app64.Config(DIM=8, BATCH_SIZE=4, BF16=False), cuda, pool)
    step = app64.make_step_fn(run)
    for policy in ("float32", "bfloat16"):
        before, uniforms = dropout_mask.launches, philox_uniform.launches
        with precision_policy(policy):
            _, metrics = step(run.state, run.rand)
        assert dropout_mask.launches - before == 63 and philox_uniform.launches == uniforms
        assert all(math.isfinite(float(v)) for v in metrics.values())


def test_deconv2d_on_the_card_equals_the_cpu(cuda):
    """TF's SAME transposed conv on the card (fp32, TF32 off) against the
    CPU within 1e-5 of the output's scale, at MNIST's 7 -> 14 and an even
    size; a 2H x 2W output."""
    from ctgan_tpu_torch.ops import deconv2d

    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for h in (7, 8):
            x, w, b = torch.randn(4, 16, h, h), torch.randn(16, 8, 5, 5) * 0.1, torch.randn(8)
            want = deconv2d(x, w, b)
            got = deconv2d(x.to(cuda), w.to(cuda), b.to(cuda))
            assert got.shape == (4, 8, 2 * h, 2 * h)
            assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    finally:
        torch.backends.cudnn.allow_tf32 = old


@pytest.mark.parametrize("model", ["mnist", "cifar"])
def test_dcgan_step_on_the_card_goes_through_the_kernel(cuda, model):
    """One iteration of the MNIST or CIFAR-10 app's step at dim 8 (5 critic
    substeps, wgan-CT): 63 mask launches, no uniform draws; finite metrics,
    in fp32 and bf16."""
    from ctgan_tpu_torch.apps import ct_gan_cifar, ct_gan_mnist

    app = ct_gan_mnist if model == "mnist" else ct_gan_cifar
    run = app.setup(app.Config(DIM=8, BATCH_SIZE=4, BF16=False), cuda)
    step = ct_gan_mnist.make_step_fn(run, None if model == "mnist" else ct_gan_cifar.to_real)
    for policy in ("float32", "bfloat16"):
        before, uniforms = dropout_mask.launches, philox_uniform.launches
        with precision_policy(policy):
            _, metrics = step(run.state, run.rand)
        assert dropout_mask.launches - before == 63 and philox_uniform.launches == uniforms
        assert all(math.isfinite(float(v)) for v in metrics.values())


def test_lsun128_step_on_the_card_goes_through_the_kernel(cuda):
    """One iteration of the 128 px LSUN app's step at small widths (batch
    4, 5 critic substeps): 63 mask launches, no uniform draws; finite
    metrics, in fp32 and bf16."""
    from ctgan_tpu_torch.apps import wgan_lsun128
    from ctgan_tpu_torch.models import lsun128

    small = lsun128.Lsun128Config(dim_g_4=32, dim_g_8=16, dim_g_16=8, dim_g_32=8, dim_g_64=8, dim_d_64=8,
                                  dim_d_32=8, dim_d_16=16, dim_d_8=32)
    pool = np.random.default_rng(0).integers(0, 256, (64, 3 * 128 * 128), dtype=np.uint8)
    model_config = wgan_lsun128.model_config
    wgan_lsun128.model_config = lambda cfg: small
    try:
        run = wgan_lsun128.setup(wgan_lsun128.Config(BATCH_SIZE=4, BF16=False), cuda, pool)
    finally:
        wgan_lsun128.model_config = model_config
    step = wgan_lsun128.make_step_fn(run)
    for policy in ("float32", "bfloat16"):
        before, uniforms = dropout_mask.launches, philox_uniform.launches
        with precision_policy(policy):
            _, metrics = step(run.state, run.rand)
        assert dropout_mask.launches - before == 63 and philox_uniform.launches == uniforms
        assert all(math.isfinite(float(v)) for v in metrics.values())


def test_resnet101_step_on_the_card_launches_no_mask(cuda):
    """One iteration of the 64 px app's ``ARCH resnet101`` at dim 16, batch
    4: its D has no dropout."""
    from ctgan_tpu_torch.apps import ct_gan_64x64 as app64

    pool = (np.random.default_rng(0).integers(0, 256, (64, 3 * 64 * 64), dtype=np.uint8), np.zeros(64, np.int64))
    run = app64.setup(app64.Config(ARCH="resnet101", DIM=16, BATCH_SIZE=4, BF16=False), cuda, pool)
    before = dropout_mask.launches
    _, metrics = app64.make_step_fn(run)(run.state, run.rand)
    assert dropout_mask.launches == before
    assert all(math.isfinite(float(v)) for v in metrics.values())
