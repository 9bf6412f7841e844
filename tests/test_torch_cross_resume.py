"""Checkpoints across the packages, on the CPU: the JAX flagship app
resumes from a checkpoint the port's app wrote, and the port's app from one
the JAX app wrote (dim 16, a few iterations).  Each reports "resumed from
... at iteration N" and trains on."""

from __future__ import annotations

import os

import numpy as np
import pytest

from ctgan_tpu_torch.apps import ct_gan_cifar_resnet as app
from ctgan_tpu_torch.utils.resume import logged_progress

import torch_parity  # noqa: F401  (one intra-op thread per test worker)

SMALL = dict(DIM_G=16, DIM_D=16, BATCH_SIZE=4, N_CRITIC=2, n_examples=64, sample_every=100,
             INCEPTION_FREQUENCY=0, save_every=2)


def _cfg(tmp_path, **kw):
    return app.Config(**(SMALL | {"out_dir": str(tmp_path)} | kw))


@pytest.fixture
def small_data(monkeypatch):
    """Both apps on the first 64 training and 640 test images of the
    synthetic set, so neither draws the full 60,000."""
    import ctgan_tpu.data.cifar10 as jax_cifar10
    from ctgan_tpu_torch.data.synthetic import synthetic_cifar10

    (trx, try_), (tex, tey) = synthetic_cifar10(n_train=64, n_test=640)

    def small(data_dir=None, n_examples=None):
        n = 64 if n_examples is None else n_examples
        return {"train": (trx[:n].copy(), try_[:n].copy()), "test": (tex.copy(), tey.copy())}

    monkeypatch.setattr(jax_cifar10, "load_arrays", small)
    monkeypatch.setattr(app, "load_arrays", small)


def _jax_cfg(tmp_path, iters):
    from ctgan_tpu.apps.ct_gan_cifar_resnet import Config as JaxConfig

    return JaxConfig(ITERS=iters, BF16=False, out_dir=str(tmp_path),
                     **{k: v for k, v in SMALL.items()})


def test_jax_app_resumes_from_a_port_checkpoint(tmp_path, small_data, capsys):
    from ctgan_tpu.apps.ct_gan_cifar_resnet import main as jax_main

    app.main(cfg=_cfg(tmp_path, ITERS=2), device="cpu")
    capsys.readouterr()
    state = jax_main(cfg=_jax_cfg(tmp_path, 4))
    out = capsys.readouterr().out
    assert f"resumed from {tmp_path / 'ckpt' / 'ckpt_2.npz'} at iteration 2" in out
    assert int(state.step) == 4
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["ckpt_2.npz", "ckpt_4.npz"]
    assert logged_progress(str(tmp_path)) == 3


def test_port_app_resumes_from_a_jax_checkpoint(tmp_path, small_data, capsys):
    from ctgan_tpu.apps.ct_gan_cifar_resnet import main as jax_main

    jax_main(cfg=_jax_cfg(tmp_path, 2))
    capsys.readouterr()
    state, records = app.main(cfg=_cfg(tmp_path, ITERS=4), device="cpu")
    out = capsys.readouterr().out
    assert f"resumed from {tmp_path / 'ckpt' / 'ckpt_2.npz'} at iteration 2" in out
    assert state.step == 4 and [r["iteration"] for r in records] == [2, 3]
    assert all(np.isfinite(r["disc_cost"]) for r in records)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["ckpt_2.npz", "ckpt_4.npz"]
