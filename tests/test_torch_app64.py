"""The 64 px app of ``ctgan_tpu_torch`` (``apps/ct_gan_64x64.py``) on the
CPU, and its pieces against ``ctgan_tpu``: the input path's scaling and
flips, the seed table (whose first 64 slots keep the flagship's seeds),
checkpoints and resume within the port and across the packages, IS/FID
through the JAX run's committed scorer, and ``generate --model good64``.

The apps run at dim 8, batch 4, 2 critic iterations, on the first 64
images of the synthetic pool (the JAX app's own pool is 4,096: drawing it
takes seconds and changes nothing checked here)."""

from __future__ import annotations

import hashlib
import math
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctgan_tpu_torch.apps import ct_gan_64x64 as app
from ctgan_tpu_torch.apps import generate
from ctgan_tpu_torch.core import Randomness
from ctgan_tpu_torch.core.rng import SEED_SLOTS
from ctgan_tpu_torch.data import scale_and_flip
from ctgan_tpu_torch.data.synthetic import synthetic_images
from ctgan_tpu_torch.utils import load_checkpoint
from ctgan_tpu_torch.utils.resume import logged_progress

import torch_parity  # noqa: F401  (one intra-op thread per test worker)

ROOT = Path(__file__).resolve().parents[1]
SCORER = ROOT / "runs" / "good64_r5" / "scorer.npz"
SMALL = dict(DIM=8, BATCH_SIZE=4, CRITIC_ITERS=2, sample_every=100, inception_every=0, save_every=2)
N_SMALL_POOL = 64


def _cfg(tmp_path, **kw):
    return app.Config(**(SMALL | {"out_dir": str(tmp_path)} | kw))


@pytest.fixture
def small_pool(monkeypatch):
    """Both apps draw the first 64 images of their synthetic pool."""
    import ctgan_tpu.data.synthetic as jax_synthetic

    def small(n, channels, size, n_classes=10, seed=1234):
        return synthetic_images(N_SMALL_POOL, channels, size, n_classes, seed)

    monkeypatch.setattr(jax_synthetic, "synthetic_images", small)
    monkeypatch.setattr(app, "synthetic_images", small)


# ------------------------------------------------------------ draws and data


# sha256 of the first 64 seeds of Randomness(0) and of for_step(0), (1) and
# (781) of it, as the 64-slot table of the flagship's earlier releases drew them
FLAGSHIP_SEEDS = {None: "e575764b485e115e", 0: "ae15b6a4ffe5812c", 1: "13bd28663e630644",
                  781: "1696ac9b1b43e917"}


@pytest.mark.parametrize("step", list(FLAGSHIP_SEEDS), ids=str)
def test_flagship_seed_slots_keep_their_seeds(step):
    """The table grew to room for a 64 px iteration (63 masks) with
    headroom; slots 0-63 hold what they held, so every flagship draw keeps
    its bits, and each slot equals the scalar draw of the same seeder."""
    rand = Randomness(0, "cpu")
    rand = rand if step is None else rand.for_step(step)
    assert SEED_SLOTS >= 96 and rand.seeds.shape == (SEED_SLOTS,)
    assert hashlib.sha256(rand.seed_values[:64].tobytes()).hexdigest()[:16] == FLAGSHIP_SEEDS[step]
    seeder = np.random.default_rng(rand.seed)
    assert [int(v) for v in rand.seed_values] == [int(seeder.integers(0, 1 << 32)) for _ in range(SEED_SLOTS)]
    for _ in range(SEED_SLOTS):
        rand.take_slot()
    with pytest.raises(RuntimeError, match="Philox seeds"):
        rand.take_slot()


def test_flips_are_host_draws():
    """Half the images flip; the draw is the host generator's, the same on
    every device, and a function of the provider's seed."""
    a, b = Randomness(3, "cpu").flip(4096), Randomness(3, "cpu").flip(4096)
    assert a.dtype == torch.bool and torch.equal(a, b)
    assert not torch.equal(a, Randomness(4, "cpu").flip(4096))
    assert abs(float(a.float().mean()) - 0.5) < 5 * math.sqrt(0.25 / 4096)


def test_scale_and_flip_matches_jax():
    """The 64 px input path's math (``ctgan_tpu/data/hbm_input.py:68-74``:
    ``2 * (x / 255 - 0.5)``, then ``random_flip`` on NHWC images) with the
    JAX flips injected: equal bit for bit."""
    from ctgan_tpu.data.augment import random_flip as jax_random_flip

    k, b = 2, 3
    raw = np.random.default_rng(0).integers(0, 256, (k, b, 3 * 64 * 64), dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    x = 2.0 * (jnp.asarray(raw).astype(jnp.float32) / 255.0 - 0.5)
    imgs = jax_random_flip(x.reshape(-1, 3, 64, 64).transpose(0, 2, 3, 1), key)
    want = np.asarray(imgs.transpose(0, 3, 1, 2).reshape(k, b, -1))
    flip = torch.from_numpy(np.asarray(jax.random.bernoulli(key, 0.5, (k * b,))))
    assert 0 < int(flip.sum()) < k * b
    got = scale_and_flip(torch.from_numpy(raw), flip, (3, 64, 64))
    assert got.dtype == torch.float32 and got.shape == raw.shape
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- the app


def test_app_writes_checkpoints_and_resumes(tmp_path, small_pool, capsys):
    """Checkpoints, ``params_latest.npz`` and a grid of 64 at the JAX app's
    cadence; run again with more iterations, the app resumes at the last
    checkpoint with the sampler's position, and a resumed run's state
    equals an uninterrupted one's."""
    state, records = app.main(cfg=_cfg(tmp_path / "a", ITERS=3, sample_every=3), device="cpu")
    assert state.step == 3 and [r["iteration"] for r in records] == [0, 1, 2]
    assert all(math.isfinite(r[k]) for r in records for k in ("wgan", "ct", "gp", "disc_cost", "gen_cost"))
    assert sorted(os.listdir(tmp_path / "a" / "ckpt")) == ["ckpt_2.npz"]
    assert (tmp_path / "a" / "samples_2.png").is_file() and (tmp_path / "a" / "params_latest.npz").is_file()
    blob = load_checkpoint(str(tmp_path / "a" / "ckpt" / "ckpt_2.npz"))
    assert blob["data_state"] == {"i": 2} and int(blob["state"]["step"]) == 2
    assert set(blob["state"]) == {"gen_params", "disc_params", "gen_opt", "disc_opt", "step"}
    assert set(blob["state"]["disc_opt"]) == {"m", "v", "t"}
    capsys.readouterr()
    resumed, records = app.main(cfg=_cfg(tmp_path / "a", ITERS=4), device="cpu")
    assert f"resumed from {tmp_path / 'a' / 'ckpt' / 'ckpt_2.npz'} at iteration 2" in capsys.readouterr().out
    assert resumed.step == 4 and [r["iteration"] for r in records] == [2, 3]
    whole, _ = app.main(cfg=_cfg(tmp_path / "b", ITERS=4), device="cpu")
    for field in ("gen_params", "disc_params"):
        for k, v in getattr(whole, field).items():
            assert torch.equal(getattr(resumed, field)[k], v), k


def test_app_resumes_from_params_latest(tmp_path, small_pool, capsys):
    """With the checkpoint directory gone, ``params_latest.npz`` resumes
    the run approximately: params and step exact, optimiser state fresh."""
    state, _ = app.main(cfg=_cfg(tmp_path, ITERS=2), device="cpu")
    shutil.rmtree(tmp_path / "ckpt")
    capsys.readouterr()
    resumed, records = app.main(cfg=_cfg(tmp_path, ITERS=3, MODE="wgan-ct"), device="cpu")
    out = capsys.readouterr().out
    assert f"resumed (approximate) from {tmp_path / 'params_latest.npz'} at iteration 2" in out
    assert resumed.step == 3 and [r["iteration"] for r in records] == [2]


def test_checkpoints_move_both_ways_between_the_packages(tmp_path, small_pool, capsys):
    """The port writes ``ckpt_2``; the JAX app resumes it and trains to 4;
    the port resumes the JAX app's ``ckpt_4`` and trains to 6."""
    from ctgan_tpu.apps.ct_gan_64x64 import Config as JaxConfig
    from ctgan_tpu.apps.ct_gan_64x64 import main as jax_main

    app.main(cfg=_cfg(tmp_path, ITERS=2), device="cpu")
    capsys.readouterr()
    jax_state = jax_main(cfg=JaxConfig(ITERS=4, BF16=False, out_dir=str(tmp_path), **SMALL))
    assert f"resumed from {tmp_path / 'ckpt' / 'ckpt_2.npz'} at iteration 2" in capsys.readouterr().out
    assert int(jax_state.step) == 4 and logged_progress(str(tmp_path)) == 3
    state, records = app.main(cfg=_cfg(tmp_path, ITERS=6), device="cpu")
    assert f"resumed from {tmp_path / 'ckpt' / 'ckpt_4.npz'} at iteration 4" in capsys.readouterr().out
    assert state.step == 6 and [r["iteration"] for r in records] == [4, 5]
    assert all(math.isfinite(r["disc_cost"]) for r in records)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["ckpt_2.npz", "ckpt_4.npz", "ckpt_6.npz"]


@pytest.mark.parametrize("mode", ["wgan-gp", "lsgan", "dcgan"])
def test_app_trains_the_other_modes(tmp_path, small_pool, mode):
    """Batch norm in D and the JAX optimisers of each mode; ``dcgan``
    trains one critic batch per iteration."""
    state, records = app.main(cfg=_cfg(tmp_path, ITERS=1, MODE=mode), device="cpu")
    assert "Discriminator.Res1.N1.scale" in state.disc_params
    assert math.isfinite(records[-1]["disc_cost"]) and math.isfinite(records[-1]["gen_cost"])
    assert ("gp" in records[-1]) == (mode == "wgan-gp")
    assert app.setup(_cfg(tmp_path, MODE=mode), "cpu").sampler.k == (1 if mode == "dcgan" else 2)


def test_app_scores_with_the_committed_scorer(tmp_path, small_pool):
    """On the inception cadence the app generates in batches of 100 and
    scores IS and FID; a cached ``scorer.npz`` (the JAX run's) is read, not
    fitted."""
    (tmp_path / "s").mkdir()
    shutil.copy(SCORER, tmp_path / "s" / "scorer.npz")
    _, records = app.main(cfg=_cfg(tmp_path / "s", ITERS=2, inception_every=2, sample_every=2,
                                   inception_samples=200), device="cpu")
    last = records[-1]
    assert last["iteration"] == 1 and 1.0 <= last["inception score"] <= 10.0 and math.isfinite(last["fid"])


@pytest.mark.parametrize("arch,mode", [
    ("dcgan", "wgan-ct"), ("crippled", "dcgan"), ("fc", "wgan-gp"), ("multiplicative", "wgan-ct"),
])
def test_app_trains_the_dcgan_family_archs(tmp_path, small_pool, arch, mode):
    """``ARCH dcgan|crippled|fc|multiplicative`` (``models.dcgan``,
    ``models.fc``) train 2 iterations and checkpoint; D's norm is a layer
    norm in wgan-ct and batch norm otherwise (the same names); the DCGAN
    D's draw under the 0.02 override."""
    state, records = app.main(cfg=_cfg(tmp_path, ITERS=2, ARCH=arch, MODE=mode), device="cpu")
    assert state.step == 2 and (tmp_path / "ckpt" / "ckpt_2.npz").is_file()
    assert all(math.isfinite(r["disc_cost"]) and math.isfinite(r["gen_cost"]) for r in records)
    assert "Discriminator.BN2.scale" in state.disc_params
    assert ("Generator.1.Linear.W" in state.gen_params) == (arch == "fc")
    blob = load_checkpoint(str(tmp_path / "params_latest.npz"))
    assert set(blob["params"]["gen_params"]) == {k for k in state.gen_params}


@pytest.mark.parametrize("kw,err,match", [
    (dict(ARCH="nope"), ValueError, "unknown ARCH"),
    (dict(input="tape"), ValueError, "unknown input"),  # native and dir are ported
])
def test_app_refuses_what_is_not_ported(tmp_path, kw, err, match):
    with pytest.raises(err, match=match):
        app.main(cfg=_cfg(tmp_path, ITERS=1, **kw), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(ARCH="resnet101", REMAT=True), dict(DATA_DIR="/data", OPT_STATE_DTYPE="bfloat16"), dict(REMAT=True),
    dict(OPT_STATE_DTYPE="bfloat16"),
])
def test_app_takes_remat_and_bf16_moments(tmp_path, small_pool, kw):
    """``REMAT`` and ``OPT_STATE_DTYPE`` are ported (they were refused until
    then): two iterations and a checkpoint, then ``main`` again to 3, which
    resumes from it; with bf16 moments the resumed state's are bf16."""
    app.main(cfg=_cfg(tmp_path, ITERS=2, **kw), device="cpu")
    state, records = app.main(cfg=_cfg(tmp_path, ITERS=3, **kw), device="cpu")
    assert state.step == 3 and [r["iteration"] for r in records] == [2]
    assert math.isfinite(records[-1]["disc_cost"])
    want = torch.bfloat16 if kw.get("OPT_STATE_DTYPE") == "bfloat16" else torch.float32
    assert {t.dtype for t in state.disc_opt["m"].values()} == {want}


def test_app_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(cfg=_cfg(tmp_path, ITERS=1))
    cfg = app.parse_config(["--ITERS", "7", "--MODE", "lsgan", "--BF16", "0"])
    assert (cfg.ITERS, cfg.MODE, cfg.BF16, cfg.DIM, cfg.BATCH_SIZE, cfg.CRITIC_ITERS) == (7, "lsgan", False, 64, 64, 5)
    assert app.Config().CUDA_DROPOUT and app.Config().FUSE_MEANPOOL and app.Config().inception_samples == 1000


# --------------------------------------------------------------- serving


def test_generate_serves_good64(tmp_path, small_pool):
    """``generate --model good64`` from the app's ``params_latest.npz``:
    ``--dim`` 128 (the default) means 64, as in the JAX app; the samples
    are G's on the noise of each batch's seed, in [-1, 1]; the grid is
    10 x 10 images of 64 px."""
    state, _ = app.main(cfg=_cfg(tmp_path / "run", ITERS=2), device="cpu")
    ckpt = str(tmp_path / "run" / "params_latest.npz")
    prefix = str(tmp_path / "gen")
    samples = generate.main(cfg=generate.Config(model="good64", ckpt=ckpt, n=6, batch=3, dim=8,
                                                out_prefix=prefix), device="cpu")
    assert samples.shape == (6, 3 * 64 * 64) and np.abs(samples).max() <= 1
    from PIL import Image

    assert Image.open(prefix + ".png").size[0] % 64 == 0
    with torch.no_grad():
        want = app.good64.generator(state.gen_params, 3, Randomness(3, "cpu"), dim=8)
    np.testing.assert_allclose(samples[3:], want.numpy(), atol=1e-6)
    assert generate._width_64(generate.Config(model="good64")) == 64
