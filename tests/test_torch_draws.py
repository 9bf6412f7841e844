"""The port's draws do not depend on the device: a run's epoch permutation
and each step's noise, labels, dequantisation noise, GP alphas and dropout
masks are a function of ``(seed, step)`` alone, as the JAX package's draws
do not depend on the platform.  On the CPU the copies to the device and the
kernels are replaced by their host and plain versions, so that providers
built for ``cuda`` or ``meta`` run here; that they then draw what the CPU
provider draws shows that the device seeds nothing.  (``chip_smoke.py``'s
draws phase holds CUDA against the CPU bit for bit on the card.)"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from ctgan_tpu_torch.core import Randomness
from ctgan_tpu_torch.core import rng as rng_mod
from ctgan_tpu_torch.data import DeviceSampler
from ctgan_tpu_torch.kernels import (
    dropout_mask_reference,
    philox_uniform,
    philox_uniform_reference,
)
from ctgan_tpu_torch.kernels.dropout import philox4x32_10

DEVICES = ["cpu", "meta", "cuda"]


@pytest.fixture
def host_only(monkeypatch):
    """Every draw stays on the host: no copy, the kernels' plain versions."""
    monkeypatch.setattr(Randomness, "_to", lambda self, t: t)
    monkeypatch.setattr(rng_mod, "philox_uniform", lambda seeds, shape, scale, device, slot:
                        philox_uniform_reference(seeds, shape, scale, slot=slot))
    monkeypatch.setattr(rng_mod, "make_mask", lambda seeds, shape, kp, dtype, device, slot:
                        dropout_mask_reference(seeds, shape, kp, dtype, slot=slot))


def _step_draws(device, step: int) -> list[torch.Tensor]:
    r = Randomness(7, device).for_step(step)
    return [
        r.noise(4, 128), r.labels(8, 10), r.dequant((2, 4, 3072)), r.gp_alpha(4),
        r.dropout_mask((8, 16, 8, 8), 0.8, torch.float32, device),
        r.dropout_mask((8, 16, 8, 8), 0.5, torch.bfloat16, device),
        r.noise(4, 128),
    ]


@pytest.mark.parametrize("step", [0, 1, 781])
def test_step_draws_do_not_depend_on_the_device(host_only, step):
    want = _step_draws("cpu", step)
    for device in DEVICES[1:]:
        got = _step_draws(device, step)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), device
    other = _step_draws("cpu", step + 1)
    assert not any(torch.equal(g, w) for g, w in zip(other, want))


def test_epoch_perm_does_not_depend_on_the_device():
    arrays = [np.arange(64, dtype=np.uint8)[:, None].repeat(3, 1), np.arange(64) % 10]
    cpu = DeviceSampler(arrays, 4, 2, seed=3, device="cpu")
    meta = DeviceSampler(arrays, 4, 2, seed=3, device="meta")
    for epoch in (0, 1):
        perm = cpu.epoch_perm(epoch)
        assert torch.equal(meta.host_perm(epoch), perm) and torch.equal(cpu.host_perm(epoch), perm)
        assert meta.epoch_perm(epoch).device.type == "meta"
        assert sorted(perm.tolist()) == list(range(64))
    assert not torch.equal(cpu.epoch_perm(0), cpu.epoch_perm(1))


def test_philox_uniform_is_the_top_24_bits_of_the_mask_bits():
    """Element i is ``(bits_i >> 8) * 2**-24 * scale``, with bits_i the
    Philox word the dropout mask compares (``kernels.dropout``): exact."""
    n = 1001  # a ragged tail
    bits = philox4x32_10(torch.arange((n + 3) // 4), 99).reshape(-1)[:n]
    u = philox_uniform_reference(99, (n,))
    assert u.dtype == torch.float32
    assert torch.equal(u, (bits >> 8).double().mul(2.0**-24).float())
    scaled = philox_uniform_reference(99, (7, 11, 13), 1 / 128)
    assert torch.equal(scaled.reshape(-1), philox_uniform_reference(99, (1001,))[:1001] / 128)
    assert float(scaled.min()) >= 0.0 and float(scaled.max()) < 1 / 128


def test_philox_uniform_statistics_and_seeds():
    n = 196_608  # one critic batch of 64 CIFAR images
    u = philox_uniform_reference(5, (n,))
    assert abs(float(u.mean()) - 0.5) < 5 * math.sqrt(1 / 12 / n)
    assert abs(float(u.var()) - 1 / 12) < 1e-3
    assert torch.equal(philox_uniform_reference(5, (n,)), u)
    assert not torch.equal(philox_uniform_reference(6, (n,)), u)


def test_philox_uniform_wrapper_on_the_cpu():
    before = philox_uniform.launches
    got = philox_uniform(3, (4, 3072), 1 / 128, "cpu")
    assert torch.equal(got, philox_uniform_reference(3, (4, 3072), 1 / 128))
    assert philox_uniform.launches == before  # counts launches of the kernel only
    with pytest.raises(ValueError, match="cuda or cpu"):
        philox_uniform(3, (4,), 1.0, "meta")
    with pytest.raises(ValueError, match="uint32"):
        philox_uniform(1 << 32, (4,), 1.0, "cpu")


def _philox_draws(rand) -> list[tuple[torch.Tensor, float | None]]:
    """One flagship iteration's 38 Philox draws at a small width, in the
    trainer's order (G: 3 masks; each of 5 critic substeps: the
    dequantisation noise, the CT pair's 3 masks, the GP pass's 3), with
    host draws between them as the trainer makes them.  Each with its keep
    probability (None for the dequantisation noise)."""
    masks = lambda shape, dtype: [(rand.dropout_mask(shape, kp, dtype, "cpu"), kp) for kp in (0.8, 0.5, 0.5)]
    out = masks((8, 4, 2, 2), torch.bfloat16)
    for _ in range(5):
        rand.noise(2, 8)
        out += [(rand.dequant((2, 12)), None), *masks((8, 4, 2, 2), torch.bfloat16)]
        rand.gp_alpha(2)
        out += masks((2, 4, 2, 2), torch.float32)
    return out


@pytest.mark.parametrize("step", [0, 1, 781])
@pytest.mark.parametrize("cuda_dropout", [True, False])
def test_table_draws_are_the_int_seed_draws(step, cuda_dropout):
    """Every Philox draw of ``Randomness(seed).for_step(step)`` through its
    seed table equals the plain version of the k-th scalar seed of the NumPy
    generator seeded from ``SeedSequence([seed, step])``, built here on its
    own: the bits each draw had when the seed was passed by value."""
    seed = 7
    derived = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)
    seeder = np.random.default_rng(derived)
    got = _philox_draws(Randomness(seed, "cpu", cuda_dropout=cuda_dropout).for_step(step))
    assert len(got) == 38
    for k, (draw, kp) in enumerate(got):
        value = int(seeder.integers(0, 1 << 32))
        shape = tuple(draw.shape)
        if kp is None:
            want = philox_uniform_reference(value, shape, 1 / 128)
        else:
            want = dropout_mask_reference(value, shape, kp, draw.dtype)
        assert torch.equal(draw, want), k
