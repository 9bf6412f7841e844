"""``ctgan_tpu_torch``'s unconditional GAN trainer (``train/trainer_gan.py``)
against ``ctgan_tpu``'s on the CPU: the DCGAN and LSGAN losses, TF-RMSProp,
the gradient and weight clips, and whole iterations of every mode with the
64 px "Good" ResNet at dim 8, batch 4, 1 critic iteration, every random
draw injected from the JAX side (tests/torch_parity.py).

Tolerances: losses and optimiser steps on random inputs to fp32 rounding
(rtol 1e-6).  A substep's metrics to rtol 1e-4 (atol 1e-5); its gradients,
read from the optimiser's moments (Adam's ``m``, the square root of
RMSProp's ``ms``), to ``GRAD_RTOL`` of each tensor's largest
(``assert_grads_close``; JAX's side is the less exact one); its updated params to
atol 1e-6, except that an element may step differently where its gradient
is small: TF-Adam and a first RMSProp step move an element by about ``lr
* sign(g)`` (``lr / sqrt(1 - rho)`` for RMSProp), so where ``g`` is within
rounding of zero, or Adam's ``m`` is, two correct runs step apart.  Every
element stays within twice that step of JAX's, and the elements beyond
1e-6 carry at most 1e-3 of the substep's gradient L1 mass, leaving out the
parameters whose gradient is zero in exact arithmetic
(``good64.zero_grad_params``).
"""

from __future__ import annotations

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ctgan_tpu.losses import gan as jax_losses
from ctgan_tpu.models import good64 as jax_good64
from ctgan_tpu.train import GanConfig as JaxGanConfig
from ctgan_tpu.train import make_gan_trainer
from ctgan_tpu.train import optim as jax_optim

from ctgan_tpu_torch.bridge import from_jax_params, to_jax_params
from ctgan_tpu_torch.losses import gan as port_losses
from ctgan_tpu_torch.models import good64 as port_good64
from ctgan_tpu_torch.train import GanConfig, GanState, GanTrainer, RMSProp
from ctgan_tpu_torch.train import optim as port_optim
from ctgan_tpu_torch.train.optim import adam_mismatches

from torch_parity import JaxDraws, assert_grads_close, to_port

DIM, BATCH, N_CRITIC = 8, 4, 1
# The JAX package's own fp32 critic gradients lie up to 2.47e-3 of a tensor's
# largest from a float64 computation (wgan-ct, step 1; the port's fp32:
# 3.78e-6; tests/torch_precision_probe.py).
GRAD_RTOL = 1e-2


def test_dcgan_and_lsgan_losses_match_jax():
    rng = np.random.default_rng(0)
    d_real, d_fake = (rng.normal(scale=5.0, size=16).astype(np.float32) for _ in range(2))
    for jax_fn, port_fn in ((jax_losses.dcgan_losses, port_losses.dcgan_losses),
                            (jax_losses.lsgan_losses, port_losses.lsgan_losses)):
        want = jax_fn(jnp.asarray(d_real), jnp.asarray(d_fake))
        got = port_fn(torch.from_numpy(d_real), torch.from_numpy(d_fake))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    # bf16 logits are reduced in fp32, as JAX reduces them
    got = port_losses.dcgan_losses(torch.from_numpy(d_real).bfloat16(), torch.from_numpy(d_fake).bfloat16())
    want = jax_losses.dcgan_losses(jnp.asarray(d_real, jnp.bfloat16), jnp.asarray(d_fake, jnp.bfloat16))
    assert str(want[1].dtype) == "float32" and got[1].dtype == torch.float32
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)


def test_rmsprop_matches_jax():
    """Six TF-RMSProp steps (eps 1e-10 inside the square root) with
    momentum, on random parameters and gradients of falling scale."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    j_opt = jax_optim.rmsprop(1e-3, momentum_=0.5)
    j_state, j_params = j_opt.init(params), {k: jnp.asarray(v) for k, v in params.items()}
    p_opt = RMSProp(1e-3, momentum=0.5)
    p_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    p_state = p_opt.init(p_params)
    for step in range(6):
        grads = {k: rng.normal(size=s).astype(np.float32) * 10.0 ** -step for k, s in shapes.items()}
        j_params, j_state = j_opt.update({k: jnp.asarray(g) for k, g in grads.items()}, j_state, j_params, step)
        p_opt.update({k: torch.from_numpy(g) for k, g in grads.items()}, p_state, p_params, step)
        for k in shapes:
            np.testing.assert_allclose(p_params[k].numpy(), np.asarray(j_params[k]), rtol=1e-6, atol=1e-9)
            for slot in ("ms", "mom"):
                np.testing.assert_allclose(p_state[slot][k].numpy(), np.asarray(j_state[slot][k]), rtol=1e-5)


def test_clips_match_jax():
    rng = np.random.default_rng(1)
    grads = {"a": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=7).astype(np.float32)}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    pg = {k: torch.from_numpy(v) for k, v in grads.items()}
    np.testing.assert_allclose(float(port_optim.global_norm(pg)), float(jax_optim.global_norm(jg)), rtol=1e-6)
    for max_norm in (0.5, 100.0):  # clipped, and left alone
        (got, got_norm), (want, want_norm) = (port_optim.clip_grads_by_global_norm(pg, max_norm),
                                              jax_optim.clip_grads_by_global_norm(jg, max_norm))
        np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=1e-6)
        for k in grads:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)
    got, want = port_optim.clip_grads_by_value(pg, 0.3), jax_optim.clip_grads_by_value(jg, 0.3)
    for k in grads:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    params = {k: torch.from_numpy(v.copy()) for k, v in grads.items()}
    port_optim.clip_params_by_value(params, 0.01)  # in place
    want = jax_optim.clip_params_by_value(jg, 0.01)
    for k in grads:
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(want[k]))


def _jax_arrays(dim: int, mode: str, seed: int) -> tuple[dict, dict]:
    """(gen, disc) as JAX arrays: the port's ``init_params``, equal to the
    JAX package's (tests/test_torch_good64.py), without JAX's op-by-op
    initialisation."""
    params = {k: jnp.asarray(v) for k, v in port_good64.init_params(dim, mode, seed).items()}
    return ({k: v for k, v in params.items() if k.startswith("Generator")},
            {k: v for k, v in params.items() if k.startswith("Discriminator")})


def _models(mode: str):
    jax_gen = lambda n, noise=None: jax_good64.good64_generator(n, noise, dim=DIM)
    jax_disc = lambda x: jax_good64.good64_discriminator(x, DIM, mode=mode)
    port_gen = lambda p, n, rand, noise=None: port_good64.generator(p, n, rand, dim=DIM, noise=noise)
    port_disc = lambda p, x, rand: port_good64.discriminator(p, x, rand, dim=DIM, mode=mode)
    return (jax_gen, jax_disc), (port_gen, port_disc)


def _port_state(jax_state) -> GanState:
    def opt(o):
        return {k: from_jax_params({n: np.asarray(a) for n, a in v.items()}) if isinstance(v, dict)
                else float(v) for k, v in o.items()}

    return GanState(to_port(jax_state.gen_params), to_port(jax_state.disc_params),
                    opt(jax_state.gen_opt), opt(jax_state.disc_opt), int(jax_state.step))


def _step_bound(trainer: GanTrainer) -> float:
    """The largest move of one optimiser step on a gradient that is zero
    up to rounding."""
    opt = trainer.disc_optimizer
    if isinstance(opt, RMSProp):
        return opt.lr / math.sqrt(1.0 - opt.rho)
    return opt.lr(0) if callable(opt.lr) else opt.lr


def _assert_update_close(port: dict, port_opt: dict, jax_params: dict, jax_opt: dict, zero_grad,
                         bound: float, n_updates: int):
    """G's or D's params after a substep, and its gradients, against JAX's
    (the module's tolerances); ``n_updates`` 0: the update was dropped."""
    ours, theirs = to_jax_params(port), {k: np.asarray(v) for k, v in jax_params.items()}
    if n_updates == 0:
        assert not adam_mismatches(ours, theirs, lr=0.0, n_updates=0)
        return
    if "m" in port_opt:
        theirs_g, ours_g = jax_opt["m"], port_opt["m"]
    else:  # RMSProp's mean square: compare its square roots, |g| at a first step
        theirs_g = {k: np.sqrt(np.asarray(v)) for k, v in jax_opt["ms"].items()}
        ours_g = {k: v.sqrt() for k, v in port_opt["ms"].items()}
    assert_grads_close(theirs_g, ours_g, "gradient moment", rtol=GRAD_RTOL)
    grads = {k: np.abs(np.asarray(v, np.float64)) for k, v in theirs_g.items()}
    mass = sum(float(g.sum()) for k, g in grads.items() if k not in zero_grad)
    apart = 0.0
    for k, want in theirs.items():
        diff = np.abs(ours[k].astype(np.float64) - want)
        assert diff.max() <= 2 * bound * n_updates + 1e-6, (k, diff.max())
        if k not in zero_grad:
            apart += float(grads[k][diff > 1e-6].sum())
    assert apart <= 1e-3 * mass, apart / mass


@pytest.mark.parametrize("mode,extra", [
    ("wgan-ct", dict(lr_decay=True, iters=10)),
    ("wgan-gp", dict(clip_global_norm=1.0)),
])
def test_iterations_match_jax(mode, extra, monkeypatch):
    """The modes with a gradient penalty (``wgan``, ``dcgan`` and ``lsgan``:
    test_torch_gan_trainer_modes.py, which keeps each file's run short);
    see ``check_iterations``."""
    check_iterations(mode, extra, monkeypatch)


def check_iterations(mode: str, extra: dict, monkeypatch) -> None:
    """Two iterations of the JAX trainer, substep by substep (the jitted
    ``gen_substep`` and ``critic_substep``; step 0, whose G update is
    dropped, then step 1), against the port's substeps started from the
    same state each, with the JAX side's draws: the G cost and G's
    params, every critic metric (``gradnorm`` with ``clip_global_norm``)
    and D's params, under ``wgan`` clipped into [-0.01, 0.01].  From the
    same state each, so that an optimiser step that goes the other way on a
    gradient that is zero up to rounding (allowed) is not carried into the
    next substep's fakes.  ``dev_cost`` against the critic's ``disc_cost``
    (the JAX ``disc_cost_fn`` is the same loss).  Then the port's whole
    ``step`` at step 0."""
    gen, disc = _jax_arrays(DIM, mode, seed=5)
    draws = JaxDraws(monkeypatch, model=jax_good64)
    (jax_gen, jax_disc), (port_gen, port_disc) = _models(mode)
    jcfg = JaxGanConfig(mode=mode, batch_size=BATCH, critic_iters=N_CRITIC, **extra)
    init_state, step_fn, _, _ = make_gan_trainer(jax_gen, jax_disc, jcfg)
    trainer = GanTrainer(port_gen, port_disc, GanConfig(mode=mode, batch_size=BATCH, critic_iters=N_CRITIC,
                                                        **extra))
    real = np.random.default_rng(7).uniform(-1, 1, size=(N_CRITIC, BATCH, 3 * 64 * 64)).astype(np.float32)
    jgen, jcrit = jax.jit(step_fn.gen_substep), jax.jit(step_fn.critic_substep)
    key = jax.random.PRNGKey(123)
    states = [init_state(gen, disc)]
    for step in (0, 1):
        s_g, g_cost = jgen(states[-1], key)
        s_d, metrics = jcrit(s_g, 0, real[0], key)
        states += [s_g, s_d]
        if step == 0:
            states.append(step_fn.bump_step(s_d))
    d_passes = {"wgan-ct": 4, "wgan-gp": 3}.get(mode, 2)  # real, fake (, CT pass) (, GP)
    assert len(draws.dropouts) == 3 + 3 * d_passes  # each substep traced once: the same draws twice
    zero_grad = port_good64.zero_grad_params(mode)
    bound = _step_bound(trainer)

    for step, (before, after_g, after_d) in enumerate((states[0:3], states[3:6])):
        rand = draws.injected()
        state = _port_state(before)
        cost = trainer.gen_substep(state, rand)
        np.testing.assert_allclose(float(cost), float(jgen(before, key)[1]), rtol=1e-4, atol=1e-5)
        _assert_update_close(state.gen_params, state.gen_opt, after_g.gen_params, after_g.gen_opt,
                             zero_grad, bound, step)
        state = _port_state(after_g)
        got = trainer.critic_substep(state, torch.from_numpy(real[0]), rand)
        assert rand.exhausted() and state.step == step
        want = jcrit(after_g, 0, real[0], key)[1]
        assert set(got) == set(want) and ("gradnorm" in got) == ("clip_global_norm" in extra)
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
        _assert_update_close(state.disc_params, state.disc_opt, after_d.disc_params, after_d.disc_opt,
                             zero_grad, bound, 1)
        if "t" in state.disc_opt:
            assert state.gen_opt["t"] == float(after_d.gen_opt["t"]) == step
            assert state.disc_opt["t"] == float(after_d.disc_opt["t"])
        if mode == "wgan":
            assert max(float(p.abs().max()) for p in state.disc_params.values()) <= 0.01
        rand = draws.injected()
        with torch.no_grad():  # the G substep's draws
            trainer.gen_loss(state.gen_params, state.disc_params, rand)
        dev = trainer.dev_cost(_port_state(after_g), torch.from_numpy(real[0]), rand)
        assert rand.exhausted()
        np.testing.assert_allclose(float(dev), float(want["disc_cost"]), rtol=1e-4, atol=1e-5)

    state = _port_state(states[0])
    got = trainer.step(state, torch.from_numpy(real), draws.injected())
    assert state.step == 1 and set(got) == set(metrics) | {"gen_cost"}
    _assert_update_close(state.disc_params, state.disc_opt, states[2].disc_params, states[2].disc_opt,
                         zero_grad, bound, 1)


def test_sample_matches_jax():
    """``sample`` against the JAX trainer's ``sample_fn`` on fixed noise
    (G's batch norm over the batch given)."""
    gen, disc = _jax_arrays(DIM, "wgan-ct", seed=6)
    (jax_gen, jax_disc), (port_gen, port_disc) = _models("wgan-ct")
    init_state, _, sample_fn, _ = make_gan_trainer(jax_gen, jax_disc, JaxGanConfig(batch_size=BATCH))
    jstate = init_state(gen, disc)
    noise = np.random.default_rng(9).normal(size=(BATCH, 128)).astype(np.float32)
    want = np.asarray(jax.jit(sample_fn)(jstate, jnp.asarray(noise), jax.random.PRNGKey(0)))
    trainer = GanTrainer(port_gen, port_disc, GanConfig(batch_size=BATCH))
    got = trainer.sample(_port_state(jstate), torch.from_numpy(noise), None)
    assert got.shape == (BATCH, 3 * 64 * 64)
    assert float(np.max(np.abs(got.numpy() - want))) <= 1e-5 * float(np.max(np.abs(want)))


@pytest.mark.parametrize("kw,err,match", [
    (dict(remat=True), NotImplementedError, "item 17"),
    (dict(opt_state_dtype="bfloat16"), NotImplementedError, "item 17"),
    (dict(mode="wgan-xx"), ValueError, "unknown mode"),
])
def test_trainer_refuses_what_is_not_ported(kw, err, match):
    with pytest.raises(err, match=match):
        GanTrainer(None, None, GanConfig(**kw))
    with pytest.raises(NotImplementedError, match="item 16"):
        GanTrainer(None, None, GanConfig(), spmd_hooks=object())
