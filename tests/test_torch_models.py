"""``ctgan_tpu_torch`` models and losses against ``ctgan_tpu`` on the CPU:
fresh parameters, G and D forward passes under both FUSE_MEANPOOL arms, and
every parameter gradient of the flagship's disc and gen losses.  Small size
(dim 16, batch 4); randomness is injected from the JAX side
(tests/torch_parity.py)."""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ctgan_tpu.core import apply_context, rng_context
from ctgan_tpu.models import resnet_cifar as jax_resnet
from ctgan_tpu.train import AcganConfig as JaxAcganConfig
from ctgan_tpu.train import make_acgan_trainer

from ctgan_tpu_torch.bridge import from_jax_params, to_jax_params
from ctgan_tpu_torch.models import resnet_cifar as port_resnet
from ctgan_tpu_torch.train import AcganConfig, AcganTrainer

from torch_parity import (
    KP,
    JaxDraws,
    InjectedRandomness,
    assert_grads_close,
    jax_init_params,
    jax_model_cfg,
    port_model_cfg,
    to_port,
)

DIM = 16
BATCH = 4


@pytest.mark.parametrize("dim", [DIM, 128])
def test_fresh_params_equal_jax(dim):
    """Seed 0: same names, shapes and values as the JAX init, in the JAX
    layout.  Both draw the same NumPy stream in the same order, so the
    values are equal exactly."""
    gen, disc = jax_init_params(dim, seed=0)
    ours = port_resnet.init_params(port_model_cfg(dim), seed=0)
    theirs = {**gen, **disc}
    assert list(ours) == sorted(ours, key=list(theirs).index)
    assert set(ours) == set(theirs)
    for name, value in theirs.items():
        np.testing.assert_array_equal(ours[name], np.asarray(value), err_msg=name)


def test_bridge_round_trip_is_exact():
    gen, disc = jax_init_params(DIM, seed=3)
    params = {k: np.asarray(v) for k, v in {**gen, **disc}.items()}
    back = to_jax_params(from_jax_params(params))
    assert set(back) == set(params)
    for name, value in params.items():
        assert back[name].shape == value.shape
        np.testing.assert_array_equal(back[name], value, err_msg=name)
    port = from_jax_params(params)
    assert port["Discriminator.2.Conv1.Filters"].shape == (DIM, DIM, 3, 3)
    assert port["Generator.Input.W"].shape == (4 * 4 * DIM, 128)


@pytest.fixture(scope="module")
def params():
    return jax_init_params(DIM, seed=11)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    real = rng.uniform(-1, 1, size=(BATCH, 3072)).astype(np.float32)
    labels = rng.integers(0, 10, size=(BATCH,)).astype(np.int32)
    noise = rng.normal(size=(BATCH, 128)).astype(np.float32)
    return real, labels, noise


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_generator_forward_matches_jax(params, batch, fuse, monkeypatch):
    """fp32 on both sides; atol 2e-5 on tanh outputs in [-1, 1] covers the
    different summation orders of the convs and batch norms."""
    JaxDraws(monkeypatch, fuse_meanpool=fuse)
    gen, _ = params
    _, labels, noise = batch
    with rng_context(jax.random.PRNGKey(0)), apply_context(gen):
        want = np.asarray(jax_resnet.generator(BATCH, jnp.asarray(labels), noise=jnp.asarray(noise),
                                               cfg=jax_model_cfg(DIM)))
    got = port_resnet.generator(to_port(gen, False), BATCH, torch.from_numpy(labels).long(),
                                port_model_cfg(DIM, fuse), rand=None, noise=torch.from_numpy(noise))
    assert got.shape == (BATCH, 3072)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("kps", [KP, (1.0, 1.0, 1.0)], ids=["train", "clean"])
def test_discriminator_forward_matches_jax(params, batch, fuse, kps, monkeypatch):
    """Same dropout masks on both sides.  rtol 1e-4 / atol 1e-5 on the
    critic scores, features and ACGAN logits (fp32, different summation
    order)."""
    draws = JaxDraws(monkeypatch, fuse_meanpool=fuse)
    _, disc = params
    real, labels, _ = batch
    with apply_context(disc):
        want = jax_resnet.discriminator(jnp.asarray(real), jnp.asarray(labels), *kps, jax_model_cfg(DIM))
    rand = draws.injected()
    got = port_resnet.discriminator(to_port(disc, False), torch.from_numpy(real),
                                    torch.from_numpy(labels).long(), kps, port_model_cfg(DIM, fuse), rand)
    assert rand.exhausted()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_fused_and_unfused_port_agree(params, batch):
    """Inside the port: the stride-2 rewrite equals conv + mean pool to fp32
    rounding (atol 1e-5), with the same masks."""
    _, disc = params
    real, labels, _ = batch
    p = to_port(disc, False)
    x, y = torch.from_numpy(real), torch.from_numpy(labels).long()
    masks = [(np.random.default_rng(i).uniform(size=(BATCH, 8, 8, DIM)) < kp, kp)
             for i, kp in enumerate(KP)]
    outs = [
        port_resnet.discriminator(p, x, y, KP, port_model_cfg(DIM, fuse), InjectedRandomness(masks=masks))
        for fuse in (True, False)
    ]
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def _jax_trainer(n_critic=2):
    cfg = jax_model_cfg(DIM)
    tcfg = JaxAcganConfig(batch_size=BATCH, critic_iters=n_critic, iters=4)
    return make_acgan_trainer(
        lambda n, labels, noise=None: jax_resnet.generator(n, labels, noise=noise, cfg=cfg),
        lambda x, labels, k1, k2, k3: jax_resnet.discriminator(x, labels, k1, k2, k3, cfg),
        tcfg,
    )


def _port_trainer(fuse_ct=True, n_critic=2):
    cfg = port_model_cfg(DIM)
    return AcganTrainer(
        lambda p, n, labels, rand, noise=None: port_resnet.generator(p, n, labels, cfg, rand, noise=noise),
        lambda p, x, labels, kps, rand: port_resnet.discriminator(p, x, labels, kps, cfg, rand),
        AcganConfig(batch_size=BATCH, critic_iters=n_critic, iters=4, fuse_ct_passes=fuse_ct),
    )


@pytest.fixture(scope="module")
def jax_losses(params, batch):
    """The JAX package's disc and gen losses with their gradients, each
    jitted once with its draws recorded (tests/torch_parity.py)."""
    gen, disc = params
    real, labels, _ = batch
    with pytest.MonkeyPatch.context() as mp:
        d_draws = JaxDraws(mp)
        _, step_fn, *_ = _jax_trainer()
        (d_cost, d_metrics), d_grads = jax.jit(step_fn.pieces["disc_grad"])(
            disc, gen, jnp.asarray(real), jnp.asarray(labels), jax.random.PRNGKey(9))
    with pytest.MonkeyPatch.context() as mp:
        g_draws = JaxDraws(mp)
        _, step_fn, *_ = _jax_trainer()
        g_cost, g_grads = jax.jit(step_fn.pieces["gen_grad"])(gen, disc, jax.random.PRNGKey(4))
    return dict(disc=(d_cost, d_metrics, d_grads, d_draws), gen=(g_cost, g_grads, g_draws))


@pytest.mark.parametrize("fuse_ct", [True, False], ids=["fused_ct", "two_ct_passes"])
def test_disc_loss_grads_match_jax(params, batch, jax_losses, fuse_ct):
    """WGAN + CT + 10*GP (double backward) + ACGAN: the cost to 1e-4
    relative and every D parameter gradient to 1e-3 of its tensor's scale
    (fp32 both sides; the GP's second derivatives amplify rounding)."""
    gen, disc = params
    real, labels, _ = batch
    cost, metrics, grads, draws = jax_losses["disc"]
    masks = draws.masks()
    if not fuse_ct:
        # the JAX pass over the 4B-row pair becomes two 2B-row passes
        pair, rest = masks[:3], masks[3:]
        masks = [(m[: 2 * BATCH], kp) for m, kp in pair] + [(m[2 * BATCH:], kp) for m, kp in pair] + rest
    rand = InjectedRandomness(masks=masks, noises=draws.noises, gp_keys=draws.stream_keys["gp"])

    dp, gp_ = to_port(disc), to_port(gen)
    trainer = _port_trainer(fuse_ct)
    p_cost, p_metrics = trainer.disc_loss(dp, gp_, torch.from_numpy(real), torch.from_numpy(labels).long(), rand)
    assert rand.exhausted()
    p_grads = dict(zip(dp, torch.autograd.grad(p_cost, list(dp.values()))))
    np.testing.assert_allclose(float(p_cost.detach()), float(cost), rtol=1e-4)
    for k in ("wgan", "ct", "gp", "acgan", "acc_real", "acc_fake"):
        np.testing.assert_allclose(float(p_metrics[k].detach()), float(metrics[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    assert_grads_close(grads, p_grads, "disc")


def test_gen_loss_grads_match_jax(params, jax_losses):
    """-mean(D(G(z))) + 0.1*ACGAN through D with dropout into every G
    parameter; tolerances as for the disc loss."""
    gen, disc = params
    cost, grads, draws = jax_losses["gen"]
    rand = draws.injected()
    gp_, dp = to_port(gen), to_port(disc)
    p_cost = _port_trainer().gen_loss(gp_, dp, rand)
    assert rand.exhausted()
    p_grads = dict(zip(gp_, torch.autograd.grad(p_cost, list(gp_.values()))))
    np.testing.assert_allclose(float(p_cost.detach()), float(cost), rtol=1e-4)
    assert_grads_close(grads, p_grads, "gen")


def test_zero_grad_params_have_noise_grads(jax_losses):
    """What ``zero_grad_params`` names gets a JAX gradient that is rounding
    noise, far below the other gradients of its network."""
    names = port_resnet.zero_grad_params(port_model_cfg(DIM))
    for grads in (jax_losses["disc"][2], jax_losses["gen"][1]):
        scale = max(float(np.max(np.abs(np.asarray(g)))) for g in grads.values())
        for name in set(names) & set(grads):
            assert float(np.max(np.abs(np.asarray(grads[name])))) < 1e-4 * scale, name
