"""D's recomputation in the backward (``train.remat``) on the CPU.

* The port with ``remat`` against the port without, on the same provider:
  the flagship trainer (dim 16, batch 4, 2 critic iterations) and the 64 px
  wgan-ct trainer ("Good" ResNet, dim 8), 2 iterations.  Expected max diff
  0 (allowed: 1e-6 of each tensor's largest); both arms take the same seed
  slots, and the remat arm draws each recomputed pass's masks again: a pass
  differentiated once is recomputed once, the gradient penalty's pass
  twice (its input gradient's backward, then the parameters' backward
  through the double-backward graph, which leads back into the pass).
* The same through a captured step's providers (``CapturedStep`` run
  eagerly on the CPU): the warm-up's recording provider and the static
  buffer's views, against the eager run, max diff 0.
* ``Randomness.mark``/``replay``: a replayed mask is the mask of its slot
  and row segments, bit for bit, the provider does not move, and a replay
  makes no host draw.
* The port against JAX, both with remat, on a D that draws no mask (the 64
  px ``ARCH dcgan`` at dim 8, wgan-gp): ``tests/test_torch_gan_trainer.py``'s
  ``check_iterations`` and its tolerances.  (``ARCH resnet101``, the other
  maskless critic, misses those tolerances with remat off as well: its fp32
  gradient penalty through 101 layers differs from JAX's by 1.2e-4 of the
  cost at dim 8, and its remat step takes JAX about 50 s to compile.)
* The remat step with bf16 moments under ``parallel.data_parallel`` over 2
  gloo ranks (model axis 2: G's input projection and its bf16 moments
  stored in halves and gathered for the checkpoint) against one process,
  with ``tests/test_torch_parallel.py``'s tolerances, one bf16 ulp more on
  the moments (a value at a rounding boundary may round either way).
"""

from __future__ import annotations

import numpy as np
import pytest

import torch

from ctgan_tpu.models import dcgan as jax_dcgan

from ctgan_tpu_torch.bridge import from_jax_params, state_to_jax
from ctgan_tpu_torch.core import Randomness
from ctgan_tpu_torch.core.rng import StaticRandomness
from ctgan_tpu_torch.models import dcgan as port_dcgan
from ctgan_tpu_torch.models import good64 as port_good64
from ctgan_tpu_torch.models import resnet_cifar as port_resnet
from ctgan_tpu_torch.train import AcganConfig, AcganTrainer, GanConfig, GanTrainer
from ctgan_tpu_torch.train.capture import CapturedStep

import torch_parallel_workers as workers
from test_torch_gan_trainer import Net, check_iterations
from torch_parity import port_model_cfg

DIM, BATCH, N_CRITIC, ITERS = 16, 4, 2, 2
DIM64 = 8
REL = 1e-6  # allowed difference of the two arms, over each tensor's largest


def _flagship(remat: bool) -> tuple[AcganTrainer, object]:
    pcfg = port_model_cfg(DIM)
    trainer = AcganTrainer(
        lambda p, n, labels, rand, noise=None: port_resnet.generator(p, n, labels, pcfg, rand, noise=noise),
        lambda p, x, labels, kps, rand: port_resnet.discriminator(p, x, labels, kps, pcfg, rand),
        AcganConfig(batch_size=BATCH, critic_iters=N_CRITIC, iters=10, remat=remat),
    )
    params = from_jax_params(port_resnet.init_params(pcfg, 1))
    gen = {k: v for k, v in params.items() if k.startswith("Generator")}
    disc = {k: v for k, v in params.items() if k.startswith("Discriminator")}
    return trainer, trainer.init_state(gen, disc)


def _flagship_batch():
    rng = np.random.default_rng(7)
    return (torch.from_numpy(rng.integers(0, 256, (N_CRITIC, BATCH, 3072), dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 10, (N_CRITIC, BATCH))))


def _good64(remat: bool) -> tuple[GanTrainer, object]:
    trainer = GanTrainer(
        lambda p, n, rand, noise=None: port_good64.generator(p, n, rand, dim=DIM64, noise=noise),
        lambda p, x, rand: port_good64.discriminator(p, x, rand, dim=DIM64, mode="wgan-ct"),
        GanConfig(mode="wgan-ct", batch_size=BATCH, critic_iters=N_CRITIC, remat=remat),
    )
    params = from_jax_params(port_good64.init_params(DIM64, "wgan-ct", 2))
    gen = {k: v for k, v in params.items() if k.startswith("Generator")}
    disc = {k: v for k, v in params.items() if k.startswith("Discriminator")}
    return trainer, trainer.init_state(gen, disc)


def _good64_batch():
    return (torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, (N_CRITIC, BATCH, 3 * 64 * 64))
                             .astype(np.float32)),)


@pytest.fixture
def mask_calls(monkeypatch) -> list:
    """Every ``Randomness.dropout_mask`` call's seed slot, in order."""
    calls, plain = [], Randomness.dropout_mask

    def counted(self, *args, **kwargs):
        calls.append(self._slot)
        return plain(self, *args, **kwargs)

    monkeypatch.setattr(Randomness, "dropout_mask", counted)
    return calls


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree, np.float64)


def assert_states_equal(got, want) -> float:
    """Every array of two states (JAX layout) within ``REL`` of each
    tensor's largest; returns the largest difference."""
    worst = 0.0
    want_leaves = dict(_leaves(want))
    got_leaves = dict(_leaves(got))
    assert set(got_leaves) == set(want_leaves)
    for path, w in want_leaves.items():
        diff = float(np.abs(got_leaves[path] - w).max()) if w.size else 0.0
        assert diff <= REL * max(float(np.abs(w).max()), 1e-30), (path, diff)
        worst = max(worst, diff)
    return worst


def _run(make, batch, remat: bool, mask_calls: list) -> tuple[dict, list, list, int]:
    """``ITERS`` steps from a fresh state: the final state, each step's
    seed slots taken, the mask draws per step and the recomputations."""
    trainer, state = make(remat)
    slots, draws = [], []
    for step in range(ITERS):
        rand = Randomness(0, "cpu").for_step(step)
        before = len(mask_calls)
        trainer.step(state, *batch, rand)
        slots.append(rand._slot)
        draws.append(len(mask_calls) - before)
    return state_to_jax(state), slots, draws, getattr(trainer.disc_fn, "recomputes", 0)


@pytest.mark.parametrize("net", ["flagship", "good64"])
def test_remat_equals_the_plain_step(net, mask_calls):
    """Per iteration, masks drawn: the flagship 3 (G's pass) + 6 per critic
    substep (the fused CT pair, the GP pass) plain, and with remat again 3
    for G's and the CT pair's recomputation and 6 for the GP pass's two;
    the 64 px critic 3 in each of its 4 passes, and again 3 for each of
    the real, fake and CT passes and 6 for the GP pass."""
    make, batch = {"flagship": (_flagship, _flagship_batch()), "good64": (_good64, _good64_batch())}[net]
    plain, plain_slots, plain_draws, _ = _run(make, batch, False, mask_calls)
    remat, remat_slots, remat_draws, recomputes = _run(make, batch, True, mask_calls)
    assert_states_equal(remat, plain)
    assert remat_slots == plain_slots  # the recomputations take no slot
    per_pass, passes = (3, 2) if net == "flagship" else (3, 4)
    assert plain_draws == [per_pass * (1 + passes * N_CRITIC)] * ITERS
    # G's pass and every critic pass once more, the GP pass twice more
    recomputed = 1 + (passes + 1) * N_CRITIC
    assert recomputes == ITERS * recomputed
    assert remat_draws == [plain_draws[0] + per_pass * recomputed] * ITERS


def test_remat_through_the_captured_steps_providers(mask_calls):
    """The flagship remat step through ``CapturedStep`` on the CPU (the
    warm-up steps 0 and 1 on the recording provider, then steps 2 and 3 on
    the static buffer's views, each recomputation replaying views) equals
    the eager plain step; the step takes every view its warm-up took."""
    batch = _flagship_batch()
    trainer, state = _flagship(True)

    def step_fn(state, real, labels, rand):
        return state, trainer.step(state, real, labels, rand.for_step(state.step))

    run = CapturedStep(step_fn, Randomness(0, "cpu"), name="remat", graph=False)
    for _ in range(4):
        run(state, *batch)
    assert run.warmup_calls == 2 and isinstance(run.provider, StaticRandomness)
    plain_trainer, plain_state = _flagship(False)
    for step in range(4):
        plain_trainer.step(plain_state, *batch, Randomness(0, "cpu").for_step(step))
    assert state.step == plain_state.step == 4
    assert assert_states_equal(state_to_jax(state), state_to_jax(plain_state)) == 0.0


def test_replay_reissues_a_passes_masks_on_its_rows():
    """A pass of 4 row blocks on rank 1 of 2, replayed outside its ``rows``
    block: the same masks bit for bit, on the same slots; the provider's
    cursor does not move; a replay refuses a host draw; a static
    provider's replay re-reads its views."""
    shape = (8, 4, 2, 2)
    rand = Randomness(5, "cpu", rank=1, world=2)
    rand.noise(2, 3)
    with rand.rows(4):
        mark = rand.mark()
        first = [rand.dropout_mask(shape, kp, torch.float32, "cpu") for kp in (0.8, 0.5)]
    after = rand._slot
    again = rand.replay(mark)
    assert again._blocks == 4 and rand._blocks == 1
    replayed = [again.dropout_mask(shape, kp, torch.float32, "cpu") for kp in (0.8, 0.5)]
    assert all(torch.equal(a, b) for a, b in zip(first, replayed)) and rand._slot == after == 2
    plain = rand.dropout_mask(shape, 0.8, torch.float32, "cpu")
    assert not torch.equal(plain, first[0])  # the next slot: another mask
    with pytest.raises(RuntimeError, match="replayed pass asks for a host draw"):
        again.noise(2, 3)

    static = StaticRandomness(3, "cpu")
    rec = static.record().for_step(1)
    rec.gp_alpha(4)
    m = rec.dropout_mask(shape, 0.5, torch.float32, "cpu")
    with pytest.raises(RuntimeError, match="replayed pass"):
        rec.replay(rec.mark()).gp_alpha(4)
    assert len(rec.entries) == 1  # the refused draw was not recorded
    static.freeze([])
    static.fill(1, [])
    views = static.for_step(1)
    mark = views.mark()
    alpha = views.gp_alpha(4)
    assert torch.equal(views.dropout_mask(shape, 0.5, torch.float32, "cpu"), m)
    replay = views.replay(mark)
    assert torch.equal(replay.gp_alpha(4), alpha)
    assert torch.equal(replay.dropout_mask(shape, 0.5, torch.float32, "cpu"), m)
    assert views.used == 1 and views._slot == 1


def test_remat_refuses_a_provider_that_cannot_replay():
    trainer, state = _good64(True)
    with pytest.raises(TypeError, match="replay"):
        trainer.disc_fn(state.disc_params, torch.zeros(2, 3 * 64 * 64), object())


# ------------------------------------------------------------------ against JAX


def dcgan64_net() -> Net:
    """The 64 px app's ``ARCH dcgan`` at dim 8 (``ctgan_tpu/apps/ct_gan_64x64.py:67-99``):
    DCGAN G and D, no dropout."""
    fns = dict(dim=DIM64)
    jax_fns = (lambda n, noise=None: jax_dcgan.dcgan64_generator(n, noise, **fns),
               lambda x: jax_dcgan.dcgan64_discriminator(x, mode="wgan-gp", **fns))
    port_fns = (lambda p, n, rand, noise=None: port_dcgan.dcgan64_generator(p, n, rand, noise=noise, **fns),
                lambda p, x, rand: port_dcgan.dcgan64_discriminator(p, x, rand, mode="wgan-gp", **fns))

    def params(seed):
        import jax.numpy as jnp

        arrays = {k: jnp.asarray(v) for k, v in port_dcgan.init_params("dcgan", DIM64, "wgan-gp", seed).items()}
        return ({k: v for k, v in arrays.items() if k.startswith("Generator")},
                {k: v for k, v in arrays.items() if k.startswith("Discriminator")})

    return Net(jax_dcgan, jax_fns, port_fns, params, 3 * 64 * 64, -1.0,
               port_dcgan.zero_grad_params("dcgan", "wgan-gp"), masks_per_pass=0)


def test_remat_matches_jax_on_a_maskless_d(monkeypatch):
    """Both packages with remat on the 64 px DCGAN critic, wgan-gp: with no
    masks the two packages' recomputations cannot draw differently."""
    check_iterations("wgan-gp", dict(remat=True), monkeypatch, net=dcgan64_net())


# ------------------------------------------------------------------ over processes


def test_remat_with_bf16_moments_over_two_ranks_equals_one_process(tmp_path):
    """``data 1 x model 2`` over 2 gloo ranks with remat and bf16 moments,
    one flagship iteration at step 1 on the port's own draws: every rank
    the same, the gathered state within ``tests/test_torch_parallel.py``'s
    tolerances of one process (one bf16 ulp more on the moments); the
    gathered moments bf16 (gloo gathers bf16)."""
    from test_torch_parallel import ATOL, FLAGSHIP_LABELS, FLAGSHIP_REAL, RTOL, _dp_case, _flat, _step_bound
    from test_torch_parallel import _zero_grad, assert_ranks_equal, assert_states_close

    case = _dp_case("acgan", model=2, cfg_fields=dict(remat=True, opt_state_dtype="bfloat16"))
    assert case["real"] is FLAGSHIP_REAL and case["labels"] is FLAGSHIP_LABELS
    results = workers.run_group(2, [("train_steps:remat", case)], tmp_path)
    one = workers.train_steps(**dict(case, model=1))
    assert_ranks_equal(results, "train_steps:remat")
    got = results[0]["train_steps:remat"]
    full_w = dict(_flat(got["state"]["gen_params"]))["Generator.Input.W"].shape
    assert got["stored"]["Generator.Input.W"] == (full_w[1] // 2, full_w[0])
    for field in ("gen_opt", "disc_opt"):
        assert {a.dtype for k, a in _flat(got["state"][field]) if k.startswith(("m/", "v/"))} == {np.dtype("V2")}
    assert_states_close(got["state"], one["state"], _zero_grad("acgan", "wgan-CT"), _step_bound("acgan"),
                        fields=("gen_params", "disc_params"))
    # the moments: the fp32 tolerance and one bf16 ulp (a value near a rounding boundary may round either way)
    for field in ("gen_opt", "disc_opt"):
        want = dict(_flat(_f32(one["state"][field])))
        for k, g in _flat(_f32(got["state"][field])):
            w = want[k].astype(np.float64)
            ulp = np.where(w == 0, 0.0, 2.0 ** (np.floor(np.log2(np.abs(w) + (w == 0))) - 7))
            assert np.all(np.abs(g - w) <= RTOL * np.abs(w) + ATOL + ulp), (field, k)


def _f32(tree):
    from ctgan_tpu_torch.utils.checkpoint import as_tensor

    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return as_tensor(a).float().numpy() if a.dtype == np.dtype("V2") else a
