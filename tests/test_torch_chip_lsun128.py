"""Rehearsal on the CPU of ``chip_smoke.py``'s 128 px phases and its new
64 px ones: the 128 px critic's mask shape and launches per iteration,
``lsun128_ref`` against the pinned ``LSUN128_REF`` (the full-width model on
the CPU), ``cuda_vs_cpu_lsun128`` (here CPU against CPU: every difference
must be 0), the train128 checks on a small run and its resume, the
directory path, and ``train64_resnet101``/``train64_native``.  The pinned
reference is recomputed from the JAX package by the ``slow`` test."""

from __future__ import annotations

import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from ctgan_tpu_torch.apps import ct_gan_64x64 as app64
from ctgan_tpu_torch.apps import wgan_lsun128 as app128
from ctgan_tpu_torch.data import images_dir
from ctgan_tpu_torch.data.synthetic import synthetic_images
from ctgan_tpu_torch.models import lsun128

import torch_parity  # noqa: F401  (one intra-op thread per test worker)

ROOT = Path(__file__).resolve().parents[1]
TINY = lsun128.Lsun128Config(dim_g_4=16, dim_g_8=8, dim_g_16=8, dim_g_32=8, dim_g_64=8, dim_d_64=8, dim_d_32=8,
                             dim_d_16=8, dim_d_8=16)


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def small(monkeypatch):
    small_pool = lambda n, c, size, n_classes=10, seed=1234: synthetic_images(16, c, size, n_classes, seed)
    for module in (app64, app128, images_dir):
        monkeypatch.setattr(module, "synthetic_images", small_pool)
    monkeypatch.setattr(app128, "model_config", lambda cfg: TINY)


def test_lsun128_mask_shape_and_launches(chip_smoke):
    """63 launches per iteration at the defaults, all ``[64, 1024, 8, 8]``
    (4,194,304 elements, as the 64 px critic's largest)."""
    assert chip_smoke.lsun128_masks_per_iteration(app128.Config()) == 63
    assert chip_smoke.lsun128_masks_per_iteration(app128.Config(CRITIC_ITERS=2)) == 27
    assert chip_smoke.lsun128_mask_shapes() == [(64, 1024, 8, 8)]
    assert (64, 1024, 8, 8) in chip_smoke.all_mask_shapes()


def test_lsun128_ref_phase_rehearses_on_cpu(chip_smoke):
    """The port's full-width G and D on the CPU hold the pinned JAX
    outputs within the phase's bound (1e-4 absolute)."""
    assert chip_smoke.phase_lsun128_ref("cpu") <= chip_smoke.LSUN128_REF_BOUND


@pytest.mark.slow
def test_lsun128_ref_pinned_in_chip_smoke(chip_smoke):
    """``LSUN128_REF`` is the JAX package's own: its ``init_context(0)``,
    full-width G on the noise of ``default_rng(0)``, D at keep 1, fp32 on
    the CPU (about 20 s).  Exact to float64 printing."""
    import jax
    import jax.numpy as jnp

    from ctgan_tpu.core import apply_context, init_context, rng_context, split_params
    from ctgan_tpu.models import lsun128 as jax_lsun128

    with init_context(seed=0) as ctx:
        with rng_context(jax.random.PRNGKey(0)):
            jax_lsun128.lsun128_discriminator(jax_lsun128.lsun128_generator(2), deterministic=True)
    gen, disc, _ = split_params(ctx.params, "Generator", "Discriminator")
    noise = np.random.default_rng(0).standard_normal((chip_smoke.N_LSUN128_REF, 128), dtype=np.float32)
    with apply_context(gen):
        images = np.asarray(jax_lsun128.lsun128_generator(len(noise), jnp.asarray(noise)))
    with apply_context(disc):
        logits, _ = jax_lsun128.lsun128_discriminator(jnp.asarray(images), deterministic=True)
    assert chip_smoke.dcgan_ref_summary(images, np.asarray(logits)) == chip_smoke.LSUN128_REF


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_cuda_vs_cpu_lsun128_phase_rehearses_on_cpu(chip_smoke, monkeypatch, precision):
    monkeypatch.setattr(chip_smoke, "LSUN128_SMALL", TINY)
    assert chip_smoke.phase_cuda_vs_cpu_lsun128("cpu", precision=precision, batch=2, iters=1) == 0.0


def test_train128_phases_rehearse_on_cpu(chip_smoke, small, tmp_path):
    """train128's checks on a tiny run of 3 iterations (a grid at 1, a
    checkpoint at 2), its resume from ``ckpt_2`` to 4, and the directory
    path's synthetic fallback for 2; no kernel launches on the CPU."""
    cfg = app128.Config(ITERS=3, BATCH_SIZE=2, CRITIC_ITERS=2, save_every=2, sample_every=2,
                        out_dir=str(tmp_path / "run"))
    out = chip_smoke.phase_train128("cpu", cfg)
    assert out["launches"] == 0 and out["timed"] == "1-2" and out["peak_bytes"] is None
    assert math.isfinite(out["s_per_iter"]) and out["last"]["iteration"] == 2
    out = chip_smoke.phase_train128("cpu", dataclasses.replace(cfg, ITERS=4), start=2)
    assert out["timed"] == "2-3" and out["last"]["iteration"] == 3
    out = chip_smoke.phase_train128("cpu", dataclasses.replace(cfg, ITERS=2, input="dir",
                                                               out_dir=str(tmp_path / "dir")))
    assert out["last"]["iteration"] == 1
    assert "train128" in chip_smoke._gan_line("train128", out)


@pytest.mark.parametrize("kw", [dict(ARCH="resnet101"), dict(input="native")])
def test_train64_more_phase_rehearses_on_cpu(chip_smoke, small, tmp_path, kw):
    cfg = app64.Config(ITERS=2, DIM=16, BATCH_SIZE=2, CRITIC_ITERS=2, save_every=2, sample_every=2,
                       inception_every=0, out_dir=str(tmp_path), **kw)
    out = chip_smoke.phase_train64_more("cpu", cfg)
    assert out["launches"] == 0 and out["last"]["iteration"] == 1
    assert out["per_iteration"] == (0 if kw.get("ARCH") == "resnet101" else 27)


def test_serve_lsun128_needs_the_card(chip_smoke, small, tmp_path, monkeypatch):
    """The serving measurement refuses the CPU, after the grid of 16 is
    written and checked."""
    from ctgan_tpu_torch.apps import generate

    monkeypatch.setattr(generate, "LSUN128", TINY)
    cfg = app128.Config(ITERS=2, BATCH_SIZE=2, CRITIC_ITERS=1, save_every=2, sample_every=100,
                        out_dir=str(tmp_path / "run"))
    app128.main(cfg=cfg, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        chip_smoke.phase_serve_gan("cpu", {"lsun128": str(tmp_path / "run" / "params_latest.npz")},
                                  str(tmp_path))
    assert (tmp_path / "generated_lsun128.png").is_file()
