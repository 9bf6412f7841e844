"""The 128 px LSUN app of ``ctgan_tpu_torch`` (``apps/wgan_lsun128.py``)
on the CPU: its defaults, checkpoints and resume, checkpoints that move
both ways between it and ``ctgan_tpu``'s app, and ``generate --model
lsun128``.

The apps run the model at widths 8-32 (``models.lsun128.Lsun128Config``;
the apps' flags set only ``DIM_G_4`` and ``DIM_D_8``), batch 2, 2 critic
iterations, on the first 32 images of the synthetic pool (the app's own
pool is 2,048 128 px images, 100 MB of uint8 drawn in seconds: it changes
nothing checked here)."""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from ctgan_tpu_torch.apps import generate
from ctgan_tpu_torch.apps import wgan_lsun128 as app
from ctgan_tpu_torch.core import Randomness
from ctgan_tpu_torch.data.synthetic import synthetic_images
from ctgan_tpu_torch.models import lsun128
from ctgan_tpu_torch.utils import load_checkpoint
from ctgan_tpu_torch.utils.resume import logged_progress

import torch_parity  # noqa: F401  (one intra-op thread per test worker)

TINY = dict(dim_g_4=32, dim_g_8=16, dim_g_16=8, dim_g_32=8, dim_g_64=8, dim_d_64=8, dim_d_32=8, dim_d_16=16,
            dim_d_8=32)
SMALL = dict(BATCH_SIZE=2, CRITIC_ITERS=2, save_every=2, sample_every=2, DIM_G_4=32, DIM_D_8=32)
N_SMALL_POOL = 32


@pytest.fixture
def tiny(monkeypatch):
    """Both packages' apps build the tiny model on a 32-image pool."""
    import ctgan_tpu.data.synthetic as jax_synthetic
    from ctgan_tpu.models import lsun128 as jax_lsun128

    small = lambda n, c, s, n_classes=10, seed=1234: synthetic_images(N_SMALL_POOL, c, s, n_classes, seed)
    monkeypatch.setattr(jax_synthetic, "synthetic_images", small)
    monkeypatch.setattr(app, "synthetic_images", small)
    jax_tiny = jax_lsun128.Lsun128Config(**TINY)
    monkeypatch.setattr(jax_lsun128, "Lsun128Config", lambda dim_g_4, dim_d_8: jax_tiny)
    monkeypatch.setattr(app, "model_config", lambda cfg: lsun128.Lsun128Config(**TINY))


def _cfg(tmp_path, **kw):
    return app.Config(**(SMALL | {"out_dir": str(tmp_path)} | kw))


def test_defaults_are_the_jax_apps():
    from ctgan_tpu.apps.wgan_lsun128 import Config as JaxConfig

    ours, theirs = dataclasses.asdict(app.Config()), dataclasses.asdict(JaxConfig())
    assert ours.pop("CUDA_DROPOUT") and theirs.pop("PALLAS_DROPOUT")
    assert ours | {"out_dir": ""} == theirs | {"out_dir": ""}
    assert app.model_config(app.Config()) == lsun128.Lsun128Config()
    cfg = app.parse_config(["--ITERS", "7", "--BF16", "0", "--input", "dir"])
    assert (cfg.ITERS, cfg.BF16, cfg.input, cfg.BATCH_SIZE) == (7, False, "dir", 64)


def test_app_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(cfg=_cfg(tmp_path, ITERS=1))


@pytest.mark.parametrize("kw,err,match", [
    (dict(input="native"), ValueError, "unknown input"),
])
def test_app_refuses_what_is_not_ported(tmp_path, kw, err, match):
    with pytest.raises(err, match=match):
        app.main(cfg=_cfg(tmp_path, ITERS=1, **kw), device="cpu")


@pytest.mark.parametrize("kw", [dict(REMAT=True), dict(OPT_STATE_DTYPE="bfloat16")])
def test_app_takes_remat_and_bf16_moments(tmp_path, tiny, kw):
    """``REMAT`` and ``OPT_STATE_DTYPE`` are ported (they were refused until
    then): two iterations, then ``main`` again to 3 resumes; with bf16
    moments the resumed state's are bf16."""
    app.main(cfg=_cfg(tmp_path, ITERS=2, **kw), device="cpu")
    state, records = app.main(cfg=_cfg(tmp_path, ITERS=3, **kw), device="cpu")
    assert state.step == 3 and [r["iteration"] for r in records] == [2]
    want = torch.bfloat16 if kw.get("OPT_STATE_DTYPE") == "bfloat16" else torch.float32
    assert {t.dtype for t in state.disc_opt["m"].values()} == {want}


def test_app_writes_checkpoints_and_resumes(tmp_path, tiny, capsys):
    """4 iterations with grids and checkpoints every 2; then ``main`` to 6
    resumes at 4; the grid is 8 x 8 images of 128 px."""
    state, records = app.main(cfg=_cfg(tmp_path, ITERS=4), device="cpu")
    assert state.step == 4 and [r["iteration"] for r in records] == [0, 1, 2, 3]
    assert all(math.isfinite(r[k]) for r in records for k in ("wgan", "ct", "gp", "disc_cost", "gen_cost"))
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["ckpt_2.npz", "ckpt_4.npz"]
    assert (tmp_path / "samples_1.png").is_file() and (tmp_path / "samples_3.png").is_file()
    from PIL import Image

    assert Image.open(tmp_path / "samples_3.png").size == (8 * 128, 8 * 128)
    assert "Discriminator.8_2.Conv2.Filters" in state.disc_params
    state, records = app.main(cfg=_cfg(tmp_path, ITERS=6), device="cpu")
    assert f"resumed from {tmp_path / 'ckpt' / 'ckpt_4.npz'} at iteration 4" in capsys.readouterr().out
    assert state.step == 6 and [r["iteration"] for r in records] == [4, 5]
    blob = load_checkpoint(str(tmp_path / "params_latest.npz"))
    assert set(blob["params"]["gen_params"]) == set(state.gen_params)


def test_checkpoints_move_both_ways_between_the_packages(tmp_path, tiny, capsys):
    """The port writes ``ckpt_2``; the JAX app resumes it and trains to 4
    (one critic iteration, which halves its compile); the port resumes the
    JAX app's ``ckpt_4`` and trains to 6."""
    from ctgan_tpu.apps.wgan_lsun128 import Config as JaxConfig
    from ctgan_tpu.apps.wgan_lsun128 import main as jax_main

    app.main(cfg=_cfg(tmp_path, ITERS=2), device="cpu")
    capsys.readouterr()
    jax_state = jax_main(cfg=JaxConfig(ITERS=4, BF16=False, out_dir=str(tmp_path), **(SMALL | {"CRITIC_ITERS": 1})))
    assert f"resumed from {tmp_path / 'ckpt' / 'ckpt_2.npz'} at iteration 2" in capsys.readouterr().out
    assert int(jax_state.step) == 4 and logged_progress(str(tmp_path)) == 3
    state, records = app.main(cfg=_cfg(tmp_path, ITERS=6), device="cpu")
    assert f"resumed from {tmp_path / 'ckpt' / 'ckpt_4.npz'} at iteration 4" in capsys.readouterr().out
    assert state.step == 6 and [r["iteration"] for r in records] == [4, 5]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["ckpt_2.npz", "ckpt_4.npz", "ckpt_6.npz"]


def test_generate_serves_lsun128(tmp_path, tiny, monkeypatch):
    """``generate --model lsun128`` from the app's ``params_latest.npz``:
    the samples are G's on the noise of each batch's seed, in [-1, 1]; the
    grid is 128 px images.  The model is the default widths unless the
    module's ``LSUN128`` says otherwise (here the tiny one)."""
    assert generate.LSUN128 == lsun128.Lsun128Config()
    monkeypatch.setattr(generate, "LSUN128", lsun128.Lsun128Config(**TINY))
    state, _ = app.main(cfg=_cfg(tmp_path / "run", ITERS=2), device="cpu")
    prefix = str(tmp_path / "gen")
    samples = generate.main(cfg=generate.Config(model="lsun128", ckpt=str(tmp_path / "run" / "params_latest.npz"),
                                                n=4, batch=2, out_prefix=prefix), device="cpu")
    assert samples.shape == (4, 3 * 128 * 128) and np.abs(samples).max() <= 1
    from PIL import Image

    assert Image.open(prefix + ".png").size[0] % 128 == 0
    with torch.no_grad():
        want = lsun128.generator(state.gen_params, 2, Randomness(2, "cpu"), cfg=lsun128.Lsun128Config(**TINY))
    np.testing.assert_allclose(samples[2:], want.numpy(), atol=1e-6)
