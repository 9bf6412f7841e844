"""The MNIST and CIFAR-10 conv apps of ``ctgan_tpu_torch``
(``apps/ct_gan_mnist.py``, ``apps/ct_gan_cifar.py``) on the CPU, and
``generate --model mnist|cifar``: checkpoints, grids, ``disc_params.npz``,
resume within the port and across the packages, the inception score
through the flagship's committed scorer, and the apps' defaults.

The apps run at dim 8, batch 4, 2 critic iterations, on small synthetic
sets (MNIST 500 / 100 / 100, CIFAR 256 / 64 images; the real draws take
seconds and change nothing checked here)."""

from __future__ import annotations

import math
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from ctgan_tpu_torch.apps import ct_gan_cifar as cifar_app
from ctgan_tpu_torch.apps import ct_gan_mnist as mnist_app
from ctgan_tpu_torch.apps import generate
from ctgan_tpu_torch.core import Randomness
from ctgan_tpu_torch.data import cifar10, mnist
from ctgan_tpu_torch.data.synthetic import synthetic_images, synthetic_mnist
from ctgan_tpu_torch.models import dcgan
from ctgan_tpu_torch.utils import load_checkpoint
from ctgan_tpu_torch.utils.resume import logged_progress

import torch_parity  # noqa: F401  (one intra-op thread per test worker)

ROOT = Path(__file__).resolve().parents[1]
SCORER = ROOT / "runs" / "flagship_fused_r4" / "scorer.npz"  # a TrainedScorer of 32 px RGB
SMALL = dict(DIM=8, BATCH_SIZE=4, CRITIC_ITERS=2, sample_every=2, save_every=2)


@pytest.fixture
def small_data(monkeypatch):
    """Both packages draw small synthetic MNIST and CIFAR-10 sets."""
    import ctgan_tpu.data.cifar10 as jax_cifar10
    import ctgan_tpu.data.mnist as jax_mnist

    small_mnist = lambda: synthetic_mnist(500, 100, 100)
    small_cifar = lambda: (synthetic_images(256, 3, 32, seed=4321), synthetic_images(64, 3, 32, seed=4322))
    monkeypatch.setattr(jax_mnist, "synthetic_mnist", small_mnist)
    monkeypatch.setattr(jax_cifar10, "synthetic_cifar10", small_cifar)
    monkeypatch.setattr(mnist, "_synthetic", small_mnist)
    monkeypatch.setattr(cifar10, "_synthetic", small_cifar)


def _mnist_cfg(path, **kw):
    return mnist_app.Config(**(SMALL | {"n_examples": 64, "out_dir": str(path)} | kw))


def _cifar_cfg(path, **kw):
    return cifar_app.Config(**(SMALL | {"n_examples": 64, "inception_every": 0, "out_dir": str(path)} | kw))


def test_mnist_app_writes_checkpoints_and_resumes(tmp_path, small_data, capsys):
    """Checkpoints, ``params_latest.npz``, grids of 128 in [0, 1] and the
    dev cost at the JAX app's cadence; run again with more iterations, the
    app resumes at the last checkpoint, and the resumed state equals an
    uninterrupted run's."""
    state, records = mnist_app.main(cfg=_mnist_cfg(tmp_path / "a", ITERS=3), device="cpu")
    assert state.step == 3 and [r["iteration"] for r in records] == [0, 1, 2]
    assert all(math.isfinite(r[k]) for r in records for k in ("wgan", "ct", "gp", "disc_cost", "gen_cost"))
    assert math.isfinite(records[1]["dev disc cost"]) and "dev disc cost" not in records[0]
    assert sorted(os.listdir(tmp_path / "a" / "ckpt")) == ["ckpt_2.npz"]
    from PIL import Image

    grid = np.asarray(Image.open(tmp_path / "a" / "samples_1.png"))
    assert grid.ndim == 2 and grid.shape[0] % 28 == 0 and grid.size >= 128 * 28 * 28
    blob = load_checkpoint(str(tmp_path / "a" / "ckpt" / "ckpt_2.npz"))
    assert blob["data_state"] == {"i": 2} and int(blob["state"]["step"]) == 2
    assert blob["state"]["gen_params"]["Generator.2.Filters"].shape == (5, 5, 16, 32)  # HWOI
    capsys.readouterr()
    resumed, records = mnist_app.main(cfg=_mnist_cfg(tmp_path / "a", ITERS=4), device="cpu")
    assert f"resumed from {tmp_path / 'a' / 'ckpt' / 'ckpt_2.npz'} at iteration 2" in capsys.readouterr().out
    assert resumed.step == 4 and [r["iteration"] for r in records] == [2, 3]
    whole, _ = mnist_app.main(cfg=_mnist_cfg(tmp_path / "b", ITERS=4), device="cpu")
    for field in ("gen_params", "disc_params"):
        for k, v in getattr(whole, field).items():
            assert torch.equal(getattr(resumed, field)[k], v), k


@pytest.mark.parametrize("mode", ["wgan", "dcgan"])
def test_mnist_app_trains_the_other_modes(tmp_path, small_data, mode):
    """Batch norm in G and D (wgan), RMSProp and the clip; ``dcgan``
    trains one critic batch per iteration."""
    state, records = mnist_app.main(cfg=_mnist_cfg(tmp_path, ITERS=1, MODE=mode), device="cpu")
    assert ("Generator.BN1.scale" in state.gen_params) == (mode == "wgan")
    assert math.isfinite(records[-1]["disc_cost"]) and math.isfinite(records[-1]["gen_cost"])
    assert mnist_app.setup(_mnist_cfg(tmp_path, MODE=mode), "cpu").sampler.k == (1 if mode == "dcgan" else 2)
    if mode == "wgan":
        assert max(float(p.detach().abs().max()) for p in state.disc_params.values()) <= 0.01


def test_checkpoints_move_both_ways_between_the_packages(tmp_path, small_data, capsys):
    """The port writes ``ckpt_2``; the JAX MNIST app resumes it and trains
    to 4; the port resumes the JAX app's ``ckpt_4`` and trains to 6."""
    from ctgan_tpu.apps.ct_gan_mnist import Config as JaxConfig
    from ctgan_tpu.apps.ct_gan_mnist import main as jax_main

    mnist_app.main(cfg=_mnist_cfg(tmp_path, ITERS=2), device="cpu")
    capsys.readouterr()
    jax_state = jax_main(cfg=JaxConfig(ITERS=4, BF16=False, n_examples=64, out_dir=str(tmp_path), **SMALL))
    assert f"resumed from {tmp_path / 'ckpt' / 'ckpt_2.npz'} at iteration 2" in capsys.readouterr().out
    assert int(jax_state.step) == 4 and logged_progress(str(tmp_path)) == 3
    state, records = mnist_app.main(cfg=_mnist_cfg(tmp_path, ITERS=6), device="cpu")
    assert f"resumed from {tmp_path / 'ckpt' / 'ckpt_4.npz'} at iteration 4" in capsys.readouterr().out
    assert state.step == 6 and [r["iteration"] for r in records] == [4, 5]
    assert all(math.isfinite(r["disc_cost"]) for r in records)


def test_cifar_app_writes_its_test_outputs_and_resumes(tmp_path, small_data, capsys):
    """Every ``sample_every``: the dev cost, ``slope_real`` (positive,
    finite), ``disc_params.npz`` (D's parameters in the JAX layout, read by
    the JAX package's reader) and a grid; IS with a cached scorer (read,
    not fitted); then a resume."""
    from ctgan_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint

    out = tmp_path / "c"
    out.mkdir()
    shutil.copy(SCORER, out / "scorer.npz")
    cfg = _cifar_cfg(out, ITERS=2, inception_every=2, inception_samples=200)
    state, records = cifar_app.main(cfg=cfg, device="cpu")
    last = records[-1]
    assert last["iteration"] == 1 and math.isfinite(last["dev disc cost"]) and 0 < last["slope_real"] < 1e3
    assert 1.0 <= last["inception score"] <= 10.0
    dump = jax_load_checkpoint(str(out / "disc_params.npz"))
    want = {k: v.shape for k, v in dcgan.init_params("cifar", 8, "wgan-CT").items() if k.startswith("Disc")}
    assert {k: v.shape for k, v in dump.items()} == want
    np.testing.assert_array_equal(dump["Discriminator.1.Filters"],
                                  state.disc_params["Discriminator.1.Filters"].detach().permute(2, 3, 1, 0).numpy())
    assert (out / "samples_1.png").is_file() and (out / "params_latest.npz").is_file()
    capsys.readouterr()
    resumed, records = cifar_app.main(cfg=_cifar_cfg(out, ITERS=3), device="cpu")
    assert f"resumed from {out / 'ckpt' / 'ckpt_2.npz'} at iteration 2" in capsys.readouterr().out
    assert resumed.step == 3 and records[-1]["iteration"] == 2


def test_cifar_reals_are_scaled_without_dequantisation():
    raw = torch.tensor([[0, 255, 128]], dtype=torch.uint8)
    np.testing.assert_array_equal(cifar_app.to_real(raw).numpy(),
                                  (2.0 * (raw.numpy().astype(np.float32) / 255.0 - 0.5)))


@pytest.mark.parametrize("app", [mnist_app, cifar_app], ids=["mnist", "cifar"])
def test_apps_run_on_the_card_by_default(tmp_path, app):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(cfg=app.Config(ITERS=1, out_dir=str(tmp_path)))
    cfg = app.parse_config(["--ITERS", "7", "--MODE", "wgan", "--BF16", "0"])
    assert (cfg.ITERS, cfg.MODE, cfg.BF16) == (7, "wgan", False)
    defaults = app.Config()
    assert defaults.MODE == "wgan-CT" and defaults.CRITIC_ITERS == 5 and defaults.n_examples == 1000
    assert defaults.BF16 and defaults.CUDA_DROPOUT and defaults.ITERS == 50000
    if app is mnist_app:
        assert (defaults.DIM, defaults.BATCH_SIZE, defaults.sample_every) == (64, 50, 100)
    else:
        assert (defaults.DIM, defaults.BATCH_SIZE, defaults.inception_every) == (128, 64, 1000)


# --------------------------------------------------------------- serving


@pytest.mark.parametrize("model", ["mnist", "cifar"])
def test_generate_serves_the_apps_checkpoints(tmp_path, small_data, model):
    """``generate --model mnist|cifar`` from the app's
    ``params_latest.npz``: G's samples on the noise of each batch's seed,
    in [0, 1] (MNIST) or [-1, 1]; the grid's tiles are 28 or 32 px."""
    app = mnist_app if model == "mnist" else cifar_app
    cfg = _mnist_cfg(tmp_path / "run", ITERS=2) if model == "mnist" else _cifar_cfg(tmp_path / "run", ITERS=2)
    state, _ = app.main(cfg=cfg, device="cpu")
    prefix = str(tmp_path / "gen")
    samples = generate.main(cfg=generate.Config(model=model, ckpt=str(tmp_path / "run" / "params_latest.npz"),
                                                n=6, batch=3, dim=8, out_prefix=prefix), device="cpu")
    size = 28 if model == "mnist" else 32
    assert samples.shape == (6, size * size * (1 if model == "mnist" else 3))
    assert samples.min() >= (0.0 if model == "mnist" else -1.0) and samples.max() <= 1.0
    from PIL import Image

    assert Image.open(prefix + ".png").size[0] % size == 0
    gen_fn = dcgan.mnist_generator if model == "mnist" else dcgan.cifar_generator
    with torch.no_grad():
        want = gen_fn(state.gen_params, 3, Randomness(3, "cpu"), dim=8)
    np.testing.assert_allclose(samples[3:], want.numpy(), atol=1e-6)


def test_generate_widths_and_what_it_refuses():
    """``--dim`` 128 (the default) means 64 for ``mnist``, as in the JAX
    app, and 128 for ``cifar``; ``--aot`` stays refused, also for
    ``lsun128``, which is served (tests/test_torch_lsun128_app.py)."""
    assert generate._width_64(generate.Config(model="mnist")) == 64
    assert generate._value_range(generate.Config(model="mnist")) == (0.0, 1.0)
    assert generate._value_range(generate.Config(model="cifar")) == (-1.0, 1.0)
    with pytest.raises(NotImplementedError, match="item"):
        generate.main(cfg=generate.Config(model="lsun128", aot="x"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 12b"):
        generate.main(cfg=generate.Config(model="mnist", aot="x"), device="cpu")
