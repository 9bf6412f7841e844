"""Rehearsal on the CPU of the phases ``chip_smoke.py`` adds for the
training workflow: the app through the train loop with checkpoints, grids
and IS/FID, its resume, resumed-equals-uninterrupted, the PNG check and the
launch counts the card run must see."""

from __future__ import annotations

import importlib.util
import io
import math
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from ctgan_tpu_torch.apps import ct_gan_cifar_resnet as app
from ctgan_tpu_torch.bridge import from_jax_params
from ctgan_tpu_torch.core import Randomness, split_params
from ctgan_tpu_torch.kernels import dropout_mask_reference
from ctgan_tpu_torch.models import resnet_cifar
from ctgan_tpu_torch.train import AcganConfig, AcganTrainer
from ctgan_tpu_torch.utils.images import png_bytes

import torch_parity  # noqa: F401  (one intra-op thread per test worker)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_and_resume_phases_rehearse_on_cpu(chip_smoke, tmp_path, capsys):
    cfg = app.Config(ITERS=6, DIM_G=16, DIM_D=16, BATCH_SIZE=4, N_CRITIC=2, n_examples=256,
                     save_every=3, sample_every=3, INCEPTION_FREQUENCY=6, inception_samples=300,
                     out_dir=str(tmp_path))
    train = chip_smoke.phase_train("cpu", cfg)
    assert train["launches"] == 0 and train["peak_bytes"] is None
    assert train["scorer_fit_s"] is not None  # the fit's time, read from the app's output
    assert [r["iteration"] for r in train["evals"]] == [5]
    assert 1.0 <= train["evals"][0]["inception_50k"] <= 10.0
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["ckpt_3.npz", "ckpt_6.npz"]
    resume = chip_smoke.phase_resume("cpu", cfg)
    assert resume["start"] == 6 and resume["launches"] == 0
    assert resume["line"] in capsys.readouterr().out


def test_resume_equal_phase_rehearses_on_cpu(chip_smoke):
    assert chip_smoke.phase_resume_equal("cpu") == 0.0


def test_launch_counts_of_the_card_run(chip_smoke):
    """Train: 10 iterations of 33 masks and 2 test_fn calls of 6; resume:
    iterations 10 and 11, no test_fn."""
    cfg = app.Config(ITERS=10, save_every=5, sample_every=5)
    assert chip_smoke._expected_launches(cfg, 0, "cuda") == 10 * 33 + 2 * 6
    more = app.Config(ITERS=12, save_every=5, sample_every=5)
    assert chip_smoke._expected_launches(more, 10, "cuda") == 2 * 33
    assert chip_smoke._expected_launches(cfg, 0, "cpu") == 0


def test_dev_cost_mask_shapes(chip_smoke):
    """The dev cost's masks: the fused CT pair over 640 examples (about 21 M
    elements, within int32 indexing) and the GP pass."""
    shapes = chip_smoke.dev_cost_mask_shapes()
    assert shapes == [(2560, 128, 8, 8), (640, 128, 8, 8)]
    assert math.prod(shapes[0]) == 20_971_520 < 2**31


@pytest.mark.parametrize("shape", [(7, 9, 3), (5, 4)])
def test_decode_png_agrees_with_pil(chip_smoke, tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(png_bytes(img))
    np.testing.assert_array_equal(chip_smoke.decode_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    data = bytearray(path.read_bytes())
    data[-20] ^= 0xFF  # inside the IDAT chunk
    path.write_bytes(bytes(data))
    with pytest.raises((AssertionError, zlib.error)):
        chip_smoke.decode_png(path)


def test_decode_png_reads_a_pil_file(chip_smoke, tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (6, 8, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG", compress_level=0)
    (tmp_path / "p.png").write_bytes(buf.getvalue())
    try:
        np.testing.assert_array_equal(chip_smoke.decode_png(tmp_path / "p.png"), img)
    except AssertionError as e:  # PIL may pick row filters; the check refuses those by design
        assert "filters" in str(e)


def test_bf16_phases_rehearse_on_cpu(chip_smoke):
    """cuda_vs_cpu and resume_equal under the bf16 policy (CPU against CPU
    here: equal)."""
    assert chip_smoke.phase_cuda_vs_cpu("cpu", precision="bfloat16") == 0.0
    assert chip_smoke.phase_resume_equal("cpu", precision="bfloat16") == 0.0


def test_uniform_launch_counts_of_the_card_run(chip_smoke):
    """One dequantisation draw per critic substep and one per test_fn."""
    cfg = app.Config(ITERS=10, save_every=5, sample_every=5)
    assert chip_smoke._expected_uniform_launches(cfg, 0, "cuda") == 10 * 5 + 2
    more = app.Config(ITERS=12, save_every=5, sample_every=5)
    assert chip_smoke._expected_uniform_launches(more, 10, "cuda") == 2 * 5
    assert chip_smoke._expected_uniform_launches(cfg, 0, "cpu") == 0


class _Recorder:
    """Passes each draw on and records its kind and shape."""

    def __init__(self, rand):
        self.rand, self.calls = rand, []

    def __getattr__(self, kind):
        def call(*args):
            shape = args[0] if kind in ("dequant", "dropout_mask") else args[:1]
            self.calls.append((kind, tuple(shape)))
            return getattr(self.rand, kind)(*args)

        return call


def test_draws_phase_draws_what_the_trainer_draws(chip_smoke):
    """The draws phase asks for one iteration's draws in the order and at
    the shapes the trainer does (dim 16 here)."""
    cfg = app.Config(DIM_G=16, DIM_D=16, BATCH_SIZE=4, N_CRITIC=2)
    phase_rand = _Recorder(Randomness(0, "cpu"))
    chip_smoke._iteration_draws(phase_rand, "cpu", cfg)
    mcfg = resnet_cifar.ResnetCifarConfig(dim_g=16, dim_d=16)
    trainer = AcganTrainer(
        lambda p, n, lab, rand, noise=None: resnet_cifar.generator(p, n, lab, mcfg, rand, noise=noise),
        lambda p, x, lab, kps, rand: resnet_cifar.discriminator(p, x, lab, kps, mcfg, rand),
        AcganConfig(batch_size=4, critic_iters=2),
    )
    gen, disc, _ = split_params(from_jax_params(resnet_cifar.init_params(mcfg)), "Generator", "Discriminator")
    trainer_rand = _Recorder(Randomness(0, "cpu"))
    trainer.step(trainer.init_state(gen, disc), torch.zeros(2, 4, 3072, dtype=torch.uint8),
                 torch.zeros(2, 4, dtype=torch.long), trainer_rand)
    assert phase_rand.calls == trainer_rand.calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kp", [0.8, 0.5])
def test_plain_mask_at_equals_the_plain_mask(chip_smoke, dtype, kp):
    """The draws phase's sliced plain mask is the plain version's elements."""
    shape = (6, 5, 4, 3)
    index = chip_smoke._slice_index(360, k=16)
    assert index[0] == 0 and index[-1] == 359 and len(index) < 360
    whole = dropout_mask_reference(12345, shape, kp, dtype).reshape(-1)
    assert torch.equal(chip_smoke.plain_mask_at(12345, kp, dtype, index), whole[index])


def test_draws_phase_rehearses_on_cpu(chip_smoke):
    """The draws phase at dim 16 (CPU against CPU here): iteration 0 whole,
    the two later ones with their masks at slices."""
    cfg = app.Config(DIM_G=16, DIM_D=16, BATCH_SIZE=4, N_CRITIC=2)
    out = chip_smoke.phase_draws("cpu", cfg=cfg)
    per_step = 5 + 2 * 9  # G: labels, noise, 3 masks; each critic: 3 draws and 6 masks
    assert out["n_draws"] == 3 * per_step and out["n_sliced"] == 2 * (3 + 2 * 6)


@pytest.mark.parametrize("step", [0, 1])
def test_capture_phase_draws_rehearse_on_cpu(chip_smoke, step):
    """What the capture phase launches into its graph, run eagerly here: an
    iteration's Philox draws from a copy of a step's seed table (the host
    draws left out) equal that step's provider's draws, 38 of them."""
    cfg = app.Config(DIM_G=16, DIM_D=16, BATCH_SIZE=4)
    rand = Randomness(0, "cpu").for_step(step)
    table = rand.seeds.clone()
    eager = chip_smoke._iteration_draws(rand, "cpu", cfg)
    from_table = chip_smoke._iteration_draws(chip_smoke._TableDraws(table, "cpu"), "cpu", cfg)
    assert sum(d is None for d in from_table) == 2 + 2 * cfg.N_CRITIC  # labels, noise; noise, GP alphas
    assert chip_smoke.table_draws_equal(from_table, eager) == 38
    other = chip_smoke._iteration_draws(Randomness(0, "cpu").for_step(step + 1), "cpu", cfg)
    with pytest.raises(AssertionError, match="draw 2"):
        chip_smoke.table_draws_equal(from_table, other)


def test_ptxas_registers_and_launch_shapes(chip_smoke):
    report = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN1a19dropout_mask_kernelItEEvPT_lPKjijf' for 'sm_90a'
ptxas info    : Function properties for _ZN1a19dropout_mask_kernelItEEvPT_lPKjijf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN1a21philox_uniform_kernelEPflPKjif' for 'sm_90a'
ptxas info    : Used 26 registers, used 0 barriers
"""
    assert chip_smoke.ptxas_registers(report) == {"_ZN1a19dropout_mask_kernelItEEvPT_lPKjijf": 24,
                                                  "_ZN1a21philox_uniform_kernelEPflPKjif": 26}
    shapes = chip_smoke.launch_shapes()
    assert len(shapes) == 38 and shapes[-1] == ("philox_uniform", (640, 3072), torch.float32)
    assert ("dropout_mask", (64, 1024, 8, 8), torch.bfloat16) in shapes  # the 128 px critic's
    assert ("dropout_mask", (500, 128, 16, 16), torch.float32) in shapes  # the SSL classifier's at its init
    assert ("dropout_mask", (64, 256, 16, 16), torch.bfloat16) in shapes  # the 64 px critic's
    assert ("dropout_mask", (50, 128, 7, 7), torch.float32) in shapes  # MNIST's
    assert ("dropout_mask", (64, 512, 4, 4), torch.bfloat16) in shapes  # CIFAR-10's conv critic's
    assert {chip_smoke._sass_key(name, dtype) for name, _, dtype in shapes} == {
        "dropout_mask float32", "dropout_mask bfloat16", "philox_uniform"}
