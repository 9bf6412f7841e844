"""Rehearsal on the CPU of ``chip_smoke.py``'s phases for the paper's MNIST
and CIFAR-10 conv GANs: the CUDA-against-CPU comparison (here CPU against
CPU: every difference must be 0), the train phases' checks on small runs
of both apps and their resumes, the mask launches the card run must count,
and the ``dcgan_ref`` gate: its pinned numbers are the JAX package's, and
the port on the CPU meets them."""

from __future__ import annotations

import importlib.util
import math
from functools import partial
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ctgan_tpu.core import apply_context, init_context, rng_context
from ctgan_tpu.models import dcgan as jax_dcgan

from ctgan_tpu_torch.apps import ct_gan_cifar as cifar_app
from ctgan_tpu_torch.apps import ct_gan_mnist as mnist_app
from ctgan_tpu_torch.core import precision_policy

from test_torch_app_dcgan import small_data  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_cuda_vs_cpu_dcgan_phase_rehearses_on_cpu(chip_smoke, precision):
    assert chip_smoke.phase_cuda_vs_cpu_dcgan("cpu", precision=precision, dim=8, batch=4, iters=1) == 0.0


def test_mask_shapes_and_launch_counts(chip_smoke):
    """At the apps' defaults: MNIST's and CIFAR-10's critics' three shapes;
    63 launches per wgan-CT iteration (3 in G's substep, 4 D passes x 5
    critic substeps x 3); per test_fn 10 dev batches x 4 passes x 3, and
    CIFAR-10's slope monitor's 3.  The defaults' counts are whole
    multiples of the kernel's 256-element span; the ragged masks' are not,
    and the second ends in a partial 4-element group."""
    mnist, cifar = mnist_app.Config(), cifar_app.Config()
    assert chip_smoke.dcgan_mask_shapes(mnist) == [(50, 64, 14, 14), (50, 128, 7, 7), (50, 256, 4, 4)]
    assert chip_smoke.dcgan_mask_shapes(cifar) == [(64, 128, 16, 16), (64, 256, 8, 8), (64, 512, 4, 4)]
    assert all(math.prod(s) % 256 == 0 for cfg in (mnist, cifar) for s in chip_smoke.dcgan_mask_shapes(cfg))
    assert [math.prod(s) % 256 for s in chip_smoke.RAGGED_MASK_SHAPES] == [128, 190]
    odd = mnist_app.Config(BATCH_SIZE=49, DIM=63)
    assert chip_smoke.dcgan_mask_shapes(odd)[1] == chip_smoke.RAGGED_MASK_SHAPES[1]
    assert chip_smoke.gan_masks_per_iteration(mnist) == chip_smoke.gan_masks_per_iteration(cifar) == 63
    assert chip_smoke.dcgan_masks_per_test(mnist) == 120 and chip_smoke.dcgan_masks_per_test(cifar) == 123
    assert chip_smoke.gan_masks_per_iteration(mnist_app.Config(MODE="wgan")) == 33
    assert chip_smoke.dcgan_masks_per_test(mnist_app.Config(MODE="dcgan")) == 60


@pytest.mark.parametrize("module", [mnist_app, cifar_app], ids=["mnist", "cifar"])
def test_train_dcgan_phase_rehearses_on_cpu(chip_smoke, tmp_path, small_data, module):  # noqa: F811
    """The train phase's checks on a dim-8 run of 3 iterations and its
    resume to 4; no kernel launches on the CPU."""
    cfg = module.Config(ITERS=3, DIM=8, BATCH_SIZE=4, CRITIC_ITERS=2, n_examples=64, save_every=2,
                        sample_every=2, out_dir=str(tmp_path))
    if module is cifar_app:
        cfg = cifar_app.Config(**{**cfg.__dict__, "inception_every": 0})
    out = chip_smoke.phase_train_dcgan("cpu", module, cfg)
    assert out["launches"] == 0 and out["timed"] == "1-2" and out["peak_bytes"] is None
    assert math.isfinite(out["s_per_iter"]) and out["last"]["iteration"] == 2 and list(out["tests"]) == [1]
    assert ("slope_real" in out["tests"][1]) == (module is cifar_app)
    out = chip_smoke.phase_train_dcgan("cpu", module, type(cfg)(**{**cfg.__dict__, "ITERS": 4}), start=2)
    assert out["timed"] == "2-3" and out["last"]["iteration"] == 3 and list(out["tests"]) == [3]
    print(chip_smoke._dcgan_line("rehearsal", out))


def _jax_outputs(arch: str) -> dict:
    """The JAX package's G and D at seed 0, as ``DCGAN_REF`` pins them."""
    dim = 64 if arch == "mnist" else 128
    if arch == "mnist":
        gen, disc = partial(jax_dcgan.mnist_generator, dim=dim), partial(jax_dcgan.mnist_discriminator, dim=dim)
    else:
        gen, disc = partial(jax_dcgan.cifar_generator, dim=dim), partial(jax_dcgan.cifar_discriminator, dim=dim)
    with init_context(seed=0) as ctx:
        with rng_context(jax.random.PRNGKey(0)):
            disc(gen(2))
    noise = np.random.default_rng(0).standard_normal((100, 128), dtype=np.float32)
    with rng_context(jax.random.PRNGKey(0)), apply_context(dict(ctx.params)):
        images = gen(100, jnp.asarray(noise))
        logits, _ = disc(images, keep_prob=1.0)
    return images, logits


@pytest.mark.parametrize("arch", ["mnist", "cifar"])
def test_dcgan_ref_is_pinned_from_jax_and_met_on_cpu(chip_smoke, arch):
    """``DCGAN_REF`` is the JAX package's output (recomputed here: a few
    seconds on the CPU); the port's fp32 G and D on the CPU meet it within
    ``DCGAN_REF_BOUND`` (1.6e-6 measured, CIFAR-10), as the card must."""
    images, logits = _jax_outputs(arch)
    want = chip_smoke.dcgan_ref_summary(np.asarray(images), np.asarray(logits))
    assert chip_smoke._largest_gap(want, chip_smoke.DCGAN_REF[arch]) <= 1e-12
    with precision_policy("float32"):
        got = chip_smoke.dcgan_ref_outputs(arch, "cpu")
    assert chip_smoke._largest_gap(got, chip_smoke.DCGAN_REF[arch]) <= 1e-5


def test_dcgan_ref_phase_rehearses_on_cpu(chip_smoke):
    gaps = chip_smoke.phase_dcgan_ref("cpu")
    assert set(gaps) == {"mnist", "cifar"} and max(gaps.values()) <= chip_smoke.DCGAN_REF_BOUND


def test_profile_dcgan_needs_a_model_and_a_card(capsys):
    import torch

    from ctgan_tpu_torch.apps import profile_dcgan

    assert profile_dcgan.main(["lsun"]) == 2 and "usage" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert profile_dcgan.main(["mnist", "--fp32"]) == 1 and "no CUDA device" in capsys.readouterr().err
