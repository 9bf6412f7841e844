"""Rehearsal on the CPU of ``chip_smoke.py``'s 64 px phases: the
unconditional trainer's CUDA-against-CPU comparison (here CPU against CPU:
every difference must be 0), resumed-equals-uninterrupted for the 64 px
step, and the train64 phase's checks on a small run of the app."""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import pytest

from ctgan_tpu_torch.apps import ct_gan_64x64 as app64
from ctgan_tpu_torch.data.synthetic import synthetic_images

import torch_parity  # noqa: F401  (one intra-op thread per test worker)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("precision,mode", [("float32", "wgan-ct"), ("bfloat16", "wgan-ct"),
                                            ("float32", "wgan-gp")])
def test_cuda_vs_cpu_gan_phase_rehearses_on_cpu(chip_smoke, precision, mode):
    assert chip_smoke.phase_cuda_vs_cpu_gan("cpu", precision=precision, mode=mode, dim=8, iters=1) == 0.0


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_resume_equal_gan_phase_rehearses_on_cpu(chip_smoke, precision):
    assert chip_smoke.phase_resume_equal_gan("cpu", precision=precision, dim=8, iters=2) == 0.0


def test_good64_masks_per_iteration(chip_smoke):
    """63 launches per 1G+5D wgan-ct iteration; 21 at each of the three
    shapes (3 in G's substep, 4 passes x 5 critic substeps)."""
    assert chip_smoke.gan_masks_per_iteration(app64.Config()) == 63
    assert chip_smoke.gan_masks_per_iteration(app64.Config(MODE="wgan-gp")) == 48
    assert chip_smoke.gan_masks_per_iteration(app64.Config(MODE="dcgan")) == 9
    assert chip_smoke.good64_mask_shapes() == [(64, 256, 16, 16), (64, 512, 8, 8), (64, 512, 4, 4)]


def test_train64_phase_rehearses_on_cpu(chip_smoke, tmp_path, monkeypatch):
    """The train64 phase's checks on a dim-8 run of 3 iterations and its
    resume to 4, on a 64-image pool; no kernel launches on the CPU."""
    monkeypatch.setattr(app64, "synthetic_images",
                        lambda n, c, size, n_classes=10, seed=1234: synthetic_images(64, c, size, n_classes, seed))
    cfg = app64.Config(ITERS=3, DIM=8, BATCH_SIZE=4, CRITIC_ITERS=2, save_every=2, sample_every=2,
                       inception_every=0, out_dir=str(tmp_path))
    out = chip_smoke.phase_train64("cpu", cfg)
    assert out["launches"] == 0 and out["timed"] == "1-2" and out["peak_bytes"] is None
    assert math.isfinite(out["s_per_iter"]) and out["last"]["iteration"] == 2
    out = chip_smoke.phase_train64("cpu", app64.Config(**{**cfg.__dict__, "ITERS": 4}), start=2)
    assert out["timed"] == "2-3" and out["last"]["iteration"] == 3


def test_profile_64x64_needs_a_card(capsys):
    import torch

    from ctgan_tpu_torch.apps import profile_64x64, profile_flagship

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert profile_64x64.main([]) == 1 and "no CUDA device" in capsys.readouterr().err
    assert profile_flagship.family("void at::native::layer_norm_grad_input_kernel_vectorized") == "layer norm"
    assert profile_flagship.family("sm80_xmma_fprop_implicit_gemm_bf16") == "conv (cuDNN)"
