"""Sampling, dev cost, the ``generate`` app and the data split of
``ctgan_tpu_torch`` against ``ctgan_tpu`` on the CPU."""

from __future__ import annotations

import dataclasses
import io
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from ctgan_tpu.apps.generate import load_gen_params as jax_load_gen_params
from ctgan_tpu.data import cifar10 as jax_cifar10
from ctgan_tpu.models import resnet_cifar as jax_resnet
from ctgan_tpu.train import AcganConfig as JaxAcganConfig
from ctgan_tpu.train import make_acgan_trainer
from ctgan_tpu.train.trainer_acgan import AcganState as JaxAcganState
from ctgan_tpu.utils.images import make_grid as jax_make_grid

from ctgan_tpu_torch.apps import generate
from ctgan_tpu_torch.bridge import state_from_jax, state_to_jax
from ctgan_tpu_torch.data import load_arrays, load_train
from ctgan_tpu_torch.models import resnet_cifar as port_resnet
from ctgan_tpu_torch.train import AcganConfig, AcganTrainer
from ctgan_tpu_torch.utils import load_checkpoint, save_checkpoint
from ctgan_tpu_torch.utils.images import img_stretch, img_tile, make_grid, png_bytes, save_images
from ctgan_tpu_torch.utils.aot import AotMismatch

from test_real_format_data import write_cifar_fixture
from torch_parity import JaxDraws, jax_init_params, jax_model_cfg, port_model_cfg, to_port

ROOT = Path(__file__).resolve().parents[1]
JAX_CKPT = ROOT / "runs" / "flagship_fused_r4" / "ckpt" / "ckpt_25000.npz"


def _trainers(dim, batch=4, critic_iters=1):
    jcfg, pcfg = jax_model_cfg(dim), port_model_cfg(dim)
    jax_fns = make_acgan_trainer(
        lambda n, labels, noise=None: jax_resnet.generator(n, labels, noise=noise, cfg=jcfg),
        lambda x, labels, k1, k2, k3: jax_resnet.discriminator(x, labels, k1, k2, k3, jcfg),
        JaxAcganConfig(batch_size=batch, critic_iters=critic_iters),
    )
    port = AcganTrainer(
        lambda p, n, labels, rand, noise=None: port_resnet.generator(p, n, labels, pcfg, rand, noise=noise),
        lambda p, x, labels, kps, rand: port_resnet.discriminator(p, x, labels, kps, pcfg, rand),
        AcganConfig(batch_size=batch, critic_iters=critic_iters),
    )
    return jax_fns, port


@pytest.fixture(scope="module")
def jax_blob():
    return load_checkpoint(str(JAX_CKPT))


def test_samples_from_the_jax_checkpoint_equal_jax(jax_blob, monkeypatch):
    """dim 128 from ``ckpt_25000.npz``: 64 samples from the same noise and
    labels, to atol 2e-5 on tanh outputs, the tolerance of
    ``tests/test_torch_models.py``.  The port's side runs in float64: in
    fp32 on the CPU its rounding over the 8x longer sums of dim 128 depends
    on how many threads the conv backend uses, which that dim-16 tolerance
    does not cover; in float64 the difference left is JAX's fp32 rounding.
    The fp32 port is held to the float64 one at the same tolerance, scaled
    by the square root of the 8x longer sums."""
    JaxDraws(monkeypatch)
    (_, _, sample_fn, _, _), port = _trainers(128)
    rng = np.random.default_rng(0)
    noise = rng.normal(size=(64, 128)).astype(np.float32)
    labels = np.arange(64) % 10
    jstate = JaxAcganState(**jax.tree.map(jnp.asarray, jax_blob["state"]))
    want = np.asarray(sample_fn(jstate, jnp.asarray(noise), jnp.asarray(labels, jnp.int32),
                                jax.random.PRNGKey(0)))
    state = state_from_jax(jax_blob["state"], "cpu")
    got = port.sample(state, torch.from_numpy(noise), torch.from_numpy(labels), rand=None)
    assert got.shape == (64, 3072) and got.dtype == torch.float32 and not got.requires_grad
    double = dataclasses.replace(state, gen_params={k: v.double() for k, v in state.gen_params.items()})
    exact = port.sample(double, torch.from_numpy(noise).double(), torch.from_numpy(labels), rand=None)
    np.testing.assert_allclose(exact.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=2e-5 * 8 ** 0.5)


def test_dev_cost_equals_jax(monkeypatch):
    """dim 16, 8 dev examples, every draw injected from the JAX side (fake
    noise, dropout masks, GP alphas, dequantisation noise): the cost to
    rtol 1e-4, as for the training losses.  No parameter gradient is
    taken."""
    gen, disc = jax_init_params(16, seed=2)
    draws = JaxDraws(monkeypatch)
    (init_state, _, _, _, dev_cost_fn), port = _trainers(16)
    rng = np.random.default_rng(3)
    real = rng.integers(0, 256, size=(8, 3072)).astype(np.int32)
    labels = rng.integers(0, 10, size=(8,)).astype(np.int32)
    key = jax.random.PRNGKey(1)
    want = float(jax.jit(dev_cost_fn)(init_state(gen, disc), real, labels, key))
    assert len(draws.dropouts) == 6 and len(draws.noises) == 1
    dequant = np.array(jax.random.uniform(jax.random.fold_in(key, 9), real.shape, maxval=1.0 / 128))
    state = port.init_state(to_port(gen), to_port(disc))
    rand = draws.injected([dequant])
    got = port.dev_cost(state, torch.from_numpy(real.astype(np.uint8)), torch.from_numpy(labels).long(), rand)
    assert rand.exhausted()
    assert got.dim() == 0 and not got.requires_grad
    np.testing.assert_allclose(float(got), want, rtol=1e-4)
    assert all(p.grad is None for p in (*state.gen_params.values(), *state.disc_params.values()))


def test_generate_returns_labels_and_samples():
    from ctgan_tpu_torch.core import Randomness

    _, port = _trainers(8)
    gen, disc = jax_init_params(8)
    state = port.init_state(to_port(gen), to_port(disc))
    flat, labels = port.generate(state, 12, Randomness(0, "cpu"))
    again, labels2 = port.generate(state, 12, Randomness(0, "cpu"))
    assert flat.shape == (12, 3072) and labels.shape == (12,) and int(labels.max()) < 10
    assert torch.equal(flat, again) and torch.equal(labels, labels2)
    assert float(flat.abs().max()) <= 1.0


def test_generate_app_grid_from_the_jax_checkpoint(tmp_path):
    """``apps.generate`` on the JAX-written dim-128 checkpoint: the PNG
    decodes (PIL) to JAX's ``make_grid`` of the same samples, rescaled as
    the JAX app rescales them."""
    prefix = str(tmp_path / "gen")
    samples = generate.main(cfg=generate.Config(ckpt=str(JAX_CKPT), n=20, batch=10, out_prefix=prefix,
                                                save_npz=True), device="cpu")
    assert samples.shape == (20, 3072) and np.isfinite(samples).all() and np.abs(samples).max() <= 1
    want = jax_make_grid(((samples + 1.0) / 2.0).reshape(-1, 3, 32, 32))
    got = np.asarray(Image.open(prefix + ".png"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(prefix + ".npz")["samples"], samples)
    again = generate.main(cfg=generate.Config(ckpt=str(JAX_CKPT), n=20, batch=10,
                                              out_prefix=str(tmp_path / "again")), device="cpu")
    np.testing.assert_array_equal(again, samples)  # seeded


def test_load_gen_params_reads_both_packages(tmp_path, jax_blob):
    want = jax_blob["state"]["gen_params"]
    got = generate.load_gen_params(str(JAX_CKPT))
    assert set(got) == set(want)
    state = state_from_jax(jax_blob["state"], "cpu")
    path = save_checkpoint(str(tmp_path / "ckpt_1.npz"), {"state": state_to_jax(state), "loop": {"iteration": 1}})
    latest = save_checkpoint(str(tmp_path / "params_latest.npz"),
                             {"params": {"gen_params": want}, "iteration": 1})
    raw = save_checkpoint(str(tmp_path / "raw.npz"), want)
    jax_side = jax_load_gen_params(path)
    for p in (path, latest, raw):
        loaded = generate.load_gen_params(p)
        assert set(loaded) == set(want)
        for k in want:
            np.testing.assert_array_equal(loaded[k], want[k], err_msg=k)
            np.testing.assert_array_equal(np.asarray(jax_side[k]), want[k], err_msg=k)


@pytest.mark.parametrize("kw,err,match", [
    (dict(model="mnist", aot="x.bin"), SystemExit, "--ckpt"),  # --aot serves a checkpoint
    (dict(model="good64", aot="x.bin", serve_iters=3, dim=8, batch=4), AotMismatch, "not a"),  # no artifact
    (dict(model="lsun128", aot="x.bin"), SystemExit, "--ckpt"),
    (dict(model="nope", aot_save="x.bin"), ValueError, "unknown model"),  # checked before the export
    (dict(aot="x.bin"), SystemExit, "--ckpt"),
    (dict(aot="x.bin", serve_iters=3, dim=8, batch=4), AotMismatch, "not a"),
    (dict(bf16=True), SystemExit, "--ckpt"),  # --bf16 is served; a checkpoint is still needed
    (dict(model="nope"), ValueError, "unknown model"),
    (dict(), SystemExit, "--ckpt"),
    (dict(serve_iters=3, dim=8, batch=4), RuntimeError, "CUDA"),
])
def test_generate_refuses_what_is_not_ported(kw, err, match):
    with pytest.raises(err, match=match):
        generate.main(cfg=generate.Config(**kw), device="cpu")


def test_generate_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main(cfg=generate.Config(ckpt=str(JAX_CKPT)))
    assert generate.parse_config(generate.Config, ["--n", "7", "--save_npz", "true"]).n == 7


# ------------------------------------------------------------------ images


@pytest.mark.parametrize("shape", [(100, 3, 32, 32), (10, 3, 8, 8), (6, 5, 7), (7, 1, 4, 4)])
def test_grid_and_png_equal_jax(shape, tmp_path):
    x = np.random.default_rng(0).random(shape)
    want = jax_make_grid(x)
    np.testing.assert_array_equal(make_grid(x), want)
    save_images(x, str(tmp_path / "g.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "g.png")), np.squeeze(want, -1)
                                  if want.ndim == 3 and want.shape[-1] == 1 else want)


def test_tile_and_stretch_equal_jax():
    from ctgan_tpu.utils import images as jax_images

    x = np.random.default_rng(1).normal(size=(5, 4, 6))
    np.testing.assert_array_equal(img_stretch(x), jax_images.img_stretch(x))
    np.testing.assert_array_equal(img_tile(x, border=2, stretch=True),
                                  jax_images.img_tile(x, border=2, stretch=True))
    with pytest.raises(ValueError, match="PNG"):
        png_bytes(np.zeros((2, 2, 4), np.uint8))
    assert Image.open(io.BytesIO(png_bytes(np.full((3, 5), 7, np.uint8)))).size == (5, 3)


# -------------------------------------------------------------------- data


def test_load_arrays_equal_jax():
    """Without data files: the JAX package's synthetic train and test
    splits, exactly; ``n_examples`` cuts the train split only (the repair
    of the synthetic-size difference: a small run used to train on a
    different, smaller draw)."""
    want = jax_cifar10.load_arrays(None)
    got = load_arrays(None)
    for split in ("train", "test"):
        for g, w in zip(got[split], want[split]):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert got["train"][0].shape == (50000, 3072) and got["test"][0].shape == (10000, 3072)
    small = load_arrays(None, n_examples=100)
    for g, w in zip(small["train"], want["train"]):
        np.testing.assert_array_equal(g, w[:100])
    np.testing.assert_array_equal(small["test"][0], want["test"][0])
    images, labels = load_train(None, n_examples=24)
    np.testing.assert_array_equal(images, want["train"][0][:24])
    small["train"][0][0, 0] = 255 - small["train"][0][0, 0]  # callers own their arrays
    np.testing.assert_array_equal(load_arrays(None, n_examples=1)["train"][0], want["train"][0][:1])


def test_load_arrays_from_files_equal_jax(tmp_path):
    write_cifar_fixture(str(tmp_path), n_per_batch=6)
    want = jax_cifar10.load_arrays(str(tmp_path), n_examples=20)
    got = load_arrays(str(tmp_path), n_examples=20)
    for split in ("train", "test"):
        for g, w in zip(got[split], want[split]):
            np.testing.assert_array_equal(g, w)
    assert got["test"][0].shape == (6, 3072)
