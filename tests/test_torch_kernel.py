"""Contract of the dropout-mask kernel's plain PyTorch version
(``ctgan_tpu_torch/kernels/dropout.py::dropout_mask_reference``) and of the
wrapper's CPU path.  The CUDA kernel itself is held against this version
bit for bit on the card (tests/test_torch_gpu.py, chip_smoke.py).  No JAX
here."""

from __future__ import annotations

import math
import random

import numpy as np
import pytest
import torch

from ctgan_tpu_torch.core import Randomness
from ctgan_tpu_torch.core.rng import SEED_SLOTS
from ctgan_tpu_torch.kernels import (
    dropout_mask,
    dropout_mask_reference,
    philox_uniform,
    philox_uniform_reference,
    seed_table,
)
from ctgan_tpu_torch.kernels.dropout import keep_threshold, philox4x32_10
from ctgan_tpu_torch.ops import dropout, make_mask

U32 = 0xFFFFFFFF
SHAPE = (64, 16, 8, 8)


def _philox_python(counter: int, seed: int) -> list[int]:
    """Philox4x32-10 in Python integers, key (seed, 0), counter (lo, hi, 0, 0)."""
    c = [counter & U32, counter >> 32, 0, 0]
    k0, k1 = seed, 0
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + 0x9E3779B9) & U32, (k1 + 0xBB67AE85) & U32
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & U32, (p0 >> 32) ^ c[3] ^ k1, p0 & U32]
    return c


def test_philox_known_answer():
    """Random123's known-answer vector for a zero counter and key."""
    out = philox4x32_10(torch.tensor([0]), 0)[0].tolist()
    assert out == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_philox_tensor_arithmetic_matches_python_integers():
    """int64 tensors hold the 32x32 -> 64-bit products only when split into
    16-bit halves: counters and seeds at the ends of their ranges included."""
    rnd = random.Random(0)
    counters = [0, 1, U32, U32 + 1, 2**63 - 1] + [rnd.getrandbits(40) for _ in range(64)]
    for seed in (0, 1, U32, rnd.getrandbits(32)):
        got = philox4x32_10(torch.tensor(counters), seed).tolist()
        assert got == [_philox_python(c, seed) for c in counters]


@pytest.mark.parametrize("kp", [0.8, 0.5])
def test_values_and_keep_fraction(kp):
    mask = dropout_mask_reference(7, SHAPE, kp)
    assert mask.shape == SHAPE and mask.dtype == torch.float32
    scale = float(np.float32(1.0 / kp))
    values = set(torch.unique(mask).tolist())
    assert values <= {0.0, scale}
    n = mask.numel()
    frac = float((mask != 0).float().mean())
    assert abs(frac - kp) < 5 * math.sqrt(kp * (1 - kp) / n)


def test_threshold_follows_the_tpu_kernel():
    assert keep_threshold(0.5) == 1 << 31
    assert keep_threshold(0.8) == int(0.8 * 2**32)
    assert keep_threshold(1.0) == U32


def test_seed_determines_the_mask():
    a = dropout_mask_reference(11, SHAPE, 0.5)
    assert torch.equal(a, dropout_mask_reference(11, SHAPE, 0.5))
    assert not torch.equal(a, dropout_mask_reference(12, SHAPE, 0.5))


def test_element_bits_do_not_depend_on_shape():
    """Counter = element index: no blocks, no padding, so a smaller tensor's
    mask is the prefix of a larger one's."""
    big = dropout_mask_reference(5, (3, 1001), 0.5).reshape(-1)
    small = dropout_mask_reference(5, (7, 13), 0.5).reshape(-1)
    assert torch.equal(small, big[: small.numel()])


@pytest.mark.parametrize("kp", [0.8, 0.5, 0.3])
def test_bf16_mask_is_the_fp32_mask_cast(kp):
    fp32 = dropout_mask_reference(3, SHAPE, kp)
    bf16 = dropout_mask_reference(3, SHAPE, kp, torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, fp32.to(torch.bfloat16))


def test_tensor_keep_prob_takes_the_plain_arm():
    before = dropout_mask.launches
    got = make_mask(9, SHAPE, torch.tensor(0.5), torch.float32, "cpu")
    assert torch.equal(got, dropout_mask_reference(9, SHAPE, 0.5))
    assert dropout_mask.launches == before


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    before = dropout_mask.launches
    got = dropout_mask(4, SHAPE, 0.8, torch.bfloat16, device="cpu")
    assert torch.equal(got, dropout_mask_reference(4, SHAPE, 0.8, torch.bfloat16))
    assert dropout_mask.launches == before


@pytest.mark.parametrize("bad", [
    dict(dtype=torch.float16), dict(keep_prob=0.0), dict(keep_prob=1.5), dict(seed=-1), dict(seed=2**32),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = dict(seed=1, shape=(4, 4), keep_prob=0.5, dtype=torch.float32, device="cpu") | bad
    with pytest.raises((TypeError, ValueError)):
        dropout_mask(**args)


def test_keep_one_is_the_identity():
    x = torch.randn(4, 8)
    assert dropout(x, 1.0, Randomness(0, "cpu")) is x


def test_grad_and_grad_of_grad_equal_those_of_a_constant_mask():
    """The mask is data: first and second derivatives through ``dropout``
    equal those through ``x * mask`` with the same mask."""
    x = torch.randn(4, 3, 8, 8, dtype=torch.float32, requires_grad=True)
    mask = Randomness(5, "cpu").dropout_mask(tuple(x.shape), 0.5, x.dtype, x.device)
    assert not mask.requires_grad

    def derivs(fn):
        y = torch.tanh(fn(x)).square().sum()
        (g,) = torch.autograd.grad(y, x, create_graph=True)
        (gg,) = torch.autograd.grad(g.square().sum(), x)
        return g.detach(), gg

    got = derivs(lambda v: dropout(v, 0.5, Randomness(5, "cpu")))
    want = derivs(lambda v: v * mask)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


VALUES = [12345, 0, U32, 0x80000000]


@pytest.mark.parametrize("slot", range(len(VALUES)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_table_slot_equals_its_int_seed(slot, dtype):
    """A mask or uniform read from slot k of a seed table is the one of the
    int seed that slot holds, through the wrapper and the plain version."""
    table = seed_table(VALUES)
    want = dropout_mask_reference(VALUES[slot], SHAPE, 0.8, dtype)
    assert torch.equal(dropout_mask(table, SHAPE, 0.8, dtype, "cpu", slot=slot), want)
    assert torch.equal(dropout_mask_reference(table, SHAPE, 0.8, dtype, slot=slot), want)
    assert torch.equal(make_mask(table, SHAPE, 0.8, dtype, "cpu", slot=slot), want)
    assert torch.equal(philox_uniform(table, (5, 7), 1 / 128, "cpu", slot=slot),
                       philox_uniform_reference(VALUES[slot], (5, 7), 1 / 128))


def test_seed_table_holds_uint32_bit_patterns():
    table = seed_table(VALUES)
    assert table.dtype == torch.int32 and table.shape == (len(VALUES),)
    assert [v & U32 for v in table.tolist()] == VALUES
    for bad in ([-1], [1 << 32]):
        with pytest.raises(ValueError):
            seed_table(bad)


@pytest.mark.parametrize("bad", [
    dict(slot=-1), dict(slot=len(VALUES)), dict(seeds=seed_table(VALUES).long()),
    dict(seeds=seed_table(VALUES).float()), dict(seeds=seed_table(VALUES).reshape(2, 2)),
    dict(seeds=seed_table(VALUES * 2)[::2]), dict(seeds=seed_table(VALUES).to("meta")),
])
@pytest.mark.parametrize("kernel", ["dropout_mask", "philox_uniform"])
def test_wrappers_reject_a_bad_table_or_slot(bad, kernel):
    """A slot outside the table, a table of another dtype, rank or layout,
    or on another device than the output raises, on every path."""
    args = dict(seeds=seed_table(VALUES), slot=0) | bad
    with pytest.raises((TypeError, ValueError, IndexError)):
        if kernel == "dropout_mask":
            dropout_mask(args["seeds"], SHAPE, 0.5, torch.float32, "cpu", slot=args["slot"])
        else:
            philox_uniform(args["seeds"], SHAPE, 1.0, "cpu", slot=args["slot"])
    if args["seeds"].device.type == "cpu":
        with pytest.raises((TypeError, ValueError, IndexError)):
            dropout_mask_reference(args["seeds"], SHAPE, 0.5, slot=args["slot"])


def test_provider_hands_out_its_table_slot_by_slot_and_raises_past_it():
    rand = Randomness(3, "cpu")
    assert rand.seeds.dtype == torch.int32 and rand.seeds.shape == (SEED_SLOTS,)
    assert [v & U32 for v in rand.seeds.tolist()] == rand.seed_values.tolist()
    for k in range(SEED_SLOTS):
        seed = int(rand.seed_values[k])
        if k % 2:
            assert torch.equal(rand.dropout_mask((4, 4), 0.5, torch.float32, "cpu"),
                               dropout_mask_reference(seed, (4, 4), 0.5))
        else:
            assert torch.equal(rand.dequant((4, 4)), philox_uniform_reference(seed, (4, 4), 1 / 128))
    with pytest.raises(RuntimeError, match="Philox seeds"):
        rand.dropout_mask((4, 4), 0.5, torch.float32, "cpu")
    with pytest.raises(RuntimeError, match="Philox seeds"):
        rand.dequant((4, 4))
    assert rand.noise(2, 3).shape == (2, 3)  # the host draws have no slots
