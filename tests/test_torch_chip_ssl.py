"""Rehearsal on the CPU of ``chip_smoke.py``'s phases for the semi-supervised
classifiers: the ``ssl_ref`` gate (its pinned numbers are the JAX package's
logits of the JAX runs' classifiers, and the port on the CPU meets them),
the CUDA-against-CPU step (here CPU against CPU: every difference 0), the
mask shapes and the launches a step makes, and the train and resume phases
on small runs of the three variants."""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ctgan_tpu.core import apply_context
from ctgan_tpu.models import classifiers as jc
from ctgan_tpu.utils import load_checkpoint as jax_load_checkpoint

from ctgan_tpu_torch.apps import profile_ssl
from ctgan_tpu_torch.bridge import from_jax_params
from ctgan_tpu_torch.core import Randomness, split_params
from ctgan_tpu_torch.data.synthetic import synthetic_images
from ctgan_tpu_torch.models import classifiers

import torch_parity  # noqa: F401  (one intra-op thread per worker)
import torch_tiny_ssl

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _first_test_images(arch: str) -> np.ndarray:
    """The first 16 images of the synthetic test split as the apps read it
    (``data.synthetic``: CIFAR-10's test split is seed 4322, MNIST's 1236)."""
    if arch == "mnist":
        return synthetic_images(10000, 1, 28, seed=1236)[0][:16].astype(np.float32) / 255.0
    return synthetic_images(10000, 3, 32, seed=4322)[0][:16].astype(np.float32) / 255.0 - 0.5


@pytest.mark.parametrize("arch", ["cifar", "mnist"])
def test_ssl_ref_is_pinned_from_jax(chip_smoke, arch):
    """``SSL_REF`` is the JAX package's deterministic logits of the JAX
    run's classifier (recomputed here), on what the port's loaders give."""
    params = jax_load_checkpoint(str(chip_smoke.SSL_REF_PARAMS[arch]))
    fn = jc.mnist_ssl_classifier if arch == "mnist" else jc.cifar_ssl_classifier
    with apply_context({k: jnp.asarray(v) for k, v in params.items()}):
        logits = fn(jnp.asarray(_first_test_images(arch)), deterministic=True).logits
    want = chip_smoke.ssl_ref_summary(np.asarray(logits))
    assert want["argmax"] == chip_smoke.SSL_REF[arch]["argmax"]
    assert chip_smoke.ssl_ref_gap(want, chip_smoke.SSL_REF[arch]) <= 1e-12
    assert want["scale"] == chip_smoke.SSL_REF[arch]["scale"]


def test_ssl_ref_phase_rehearses_on_cpu(chip_smoke):
    """The port's fp32 classifiers on the CPU meet the pin (within 1e-6 of
    the logits' largest magnitude) and the loading gate on the first 200
    test images."""
    out = chip_smoke.phase_ssl_ref("cpu", n_test=200)
    assert set(out) == {"cifar", "mnist"}
    for arch, r in out.items():
        assert r["gap"] <= 1e-6 * chip_smoke.SSL_REF[arch]["scale"] and r["test_err"] <= chip_smoke.SSL_LOADING_GATE, arch
        assert len(r["sha256"]) == 64


@pytest.mark.parametrize("variant,batch", [("mnist", 6), ("cifar", 2), ("te", 2)])
def test_cuda_vs_cpu_ssl_phase_rehearses_on_cpu(chip_smoke, variant, batch):
    report = chip_smoke.phase_cuda_vs_cpu_ssl("cpu", variant=variant, batch=batch)
    assert report["diff"] == 0 and report["D_grad_l1"] == report["G_grad_l1"] == 0


class _CountingDraws:
    """``Randomness`` on the CPU, counting the masks asked for."""

    def __init__(self, rand: Randomness):
        self.rand, self.masks = rand, []

    def __getattr__(self, name):
        return getattr(self.rand, name)

    def dropout_mask(self, shape, keep_prob, dtype, device):
        self.masks.append((tuple(shape), keep_prob, dtype))
        return self.rand.dropout_mask(shape, keep_prob, dtype, device)


@pytest.mark.parametrize("variant", ["mnist", "cifar", "te"])
def test_ssl_mask_shapes_and_launches_per_step(chip_smoke, variant):
    """A full-width step asks for ``ssl_masks_per_step`` masks, at
    ``ssl_mask_shapes`` of its batch in fp32 (batch 2 here; the app's 100
    and the init's 500 on the card), and the byte bounds of the six shapes
    are the 3.35 TB/s figures."""
    batch = 2
    trainer = chip_smoke._ssl_trainer(variant)
    disc, gen, _ = split_params(from_jax_params(classifiers.init_params(chip_smoke.SSL_ARCH[variant], 0)),
                                "Classifier", "Generator")
    rand = _CountingDraws(Randomness(0, "cpu"))
    trainer.step(trainer.init_state(disc, gen), *chip_smoke._ssl_inputs(variant, batch, 0), rand)
    assert len(rand.masks) == chip_smoke.ssl_masks_per_step(variant)
    if variant != "mnist":
        shapes = chip_smoke.ssl_mask_shapes(batch)
        assert rand.masks == [(s, kp, torch.float32) for s, kp in zip(shapes, (0.8, 0.5, 0.5))] * len(rand.masks[::3])
    assert chip_smoke.ssl_mask_shapes(100) == [(100, 3, 32, 32), (100, 128, 16, 16), (100, 256, 8, 8)]
    bounds = [chip_smoke._bound_ms(4 * math.prod(s)) * 1e3 for s in chip_smoke.ssl_all_mask_shapes()]
    assert np.allclose(bounds, [0.36681, 3.91260, 1.95630, 1.83403, 19.56299, 9.78149], atol=1e-4)


def test_ssl_launch_shapes_join_the_kernel_phase(chip_smoke):
    rows = chip_smoke.launch_shapes()
    ssl = [(n, s, d) for n, s, d in rows if s in chip_smoke.ssl_all_mask_shapes()]
    assert ssl == [("dropout_mask", s, torch.float32) for s in chip_smoke.ssl_all_mask_shapes()]
    assert [(s, d) for s, d in chip_smoke._mask_cases() if s in chip_smoke.ssl_all_mask_shapes()] == [
        (s, (torch.float32,)) for s in chip_smoke.ssl_all_mask_shapes()]


def test_train_ssl_phases_rehearse_on_cpu(chip_smoke, tmp_path, monkeypatch):
    """``run_ssl_apps`` at the apps' defaults but small data (MNIST's real
    nets, CIFAR-10's tiny ones): every phase's checks, no launches on the
    CPU, resumed equals uninterrupted."""
    torch_tiny_ssl.apply_small_data(monkeypatch.setattr)
    torch_tiny_ssl.apply_tiny_ssl_models(monkeypatch.setattr)
    out = chip_smoke.run_ssl_apps("cpu", str(tmp_path), cifar_resume=True)
    assert out["resume_equal"] == 0.0
    assert set(out["runs"]) == {"train_ssl_mnist", "train_ssl_mnist_resume", "train_ssl_cifar",
                                "train_ssl_cifar_resume", "train_ssl_te"}
    for name, run in out["runs"].items():
        assert run["launches"] == 0 and run["per_step"] == 0 and run["peak_bytes"] is None, name
        assert math.isfinite(run["s_per_step"]) and run["s_per_epoch"] > 0 and 0 <= run["test_err"] <= 1, name
        assert run["steps"] == (6 if "mnist" in name else 2), name
        print(chip_smoke._ssl_line(name, run))
    assert out["runs"]["train_ssl_mnist_resume"]["last"]["iteration"] == 2
    assert out["runs"]["train_ssl_cifar_resume"]["last"]["iteration"] == 2


def test_profile_ssl_needs_a_model_and_a_card(capsys):
    assert profile_ssl.main(["lsun"]) == 2 and "usage" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert profile_ssl.main(["te"]) == 1 and "no CUDA device" in capsys.readouterr().err
