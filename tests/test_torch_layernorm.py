"""Layer norm in D (``NORMALIZATION_D``) against the JAX package on the CPU:
the two layer-norm ops, fresh parameters, a whole D and the critic loss's
gradients (the gradient penalty differentiates through the layer norms
twice), in fp32 at the tolerances of ``tests/test_torch_models.py``.  dim
16, batch 4; dropout masks injected from the JAX side
(tests/torch_parity.py)."""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ctgan_tpu import ops as jax_ops
from ctgan_tpu.core import apply_context, init_context, rng_context, split_params
from ctgan_tpu.models import resnet_cifar as jax_resnet
from ctgan_tpu.train import AcganConfig as JaxAcganConfig
from ctgan_tpu.train import make_acgan_trainer

from ctgan_tpu_torch import ops as port_ops
from ctgan_tpu_torch.apps import ct_gan_cifar_resnet as app
from ctgan_tpu_torch.data import synthetic_images
from ctgan_tpu_torch.models import resnet_cifar as port_resnet
from ctgan_tpu_torch.train import AcganConfig, AcganTrainer

from torch_parity import KP, InjectedRandomness, JaxDraws, assert_grads_close, nhwc_to_nchw, to_port

DIM, BATCH = 16, 4
# (conditional, acgan): the flagship's label-blind ACGAN trunk (plain layer
# norm), a conditional D without ACGAN (conditional layer norm), and an
# unconditional model
ARMS = [(True, True), (True, False), (False, False)]
ARM_IDS = ["acgan", "conditional", "unconditional"]


def _cfgs(conditional: bool, acgan: bool):
    kw = dict(dim_g=DIM, dim_d=DIM, conditional=conditional, acgan=acgan, normalization_d=True)
    return jax_resnet.ResnetCifarConfig(**kw), port_resnet.ResnetCifarConfig(**kw)


def _jax_params(cfg, seed: int = 0) -> tuple[dict, dict]:
    with init_context(seed=seed) as ctx:
        with rng_context(jax.random.PRNGKey(seed)):
            labels = jnp.zeros((2,), jnp.int32)
            jax_resnet.discriminator(jax_resnet.generator(2, labels, cfg=cfg), labels, *KP, cfg)
    gen, disc, rest = split_params(ctx.params, "Generator", "Discriminator")
    assert not rest
    return gen, disc


def _affine(rng, shape) -> dict:
    return {"scale": rng.normal(1.0, 0.3, size=shape).astype(np.float32),
            "offset": rng.normal(0.0, 0.3, size=shape).astype(np.float32)}


@pytest.mark.parametrize("conditional", [False, True], ids=["layernorm", "cond_layernorm"])
def test_layer_norm_ops_match_jax(conditional):
    """Per-example statistics over C, H and W, then a per-channel (or
    per-label per-channel) affine with non-trivial values: atol 2e-5."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 2.0, size=(BATCH, 8, 8, DIM)).astype(np.float32)
    labels = np.array([3, 0, 3, 9])
    p = _affine(rng, (10, DIM) if conditional else (DIM,))
    with apply_context({"N.scale": jnp.asarray(p["scale"]), "N.offset": jnp.asarray(p["offset"])}):
        if conditional:
            want = jax_ops.cond_layernorm("N", jnp.asarray(x), jnp.asarray(labels), 10)
        else:
            want = jax_ops.layernorm("N", jnp.asarray(x))
    xt = torch.from_numpy(nhwc_to_nchw(x))
    scale, offset = torch.from_numpy(p["scale"]), torch.from_numpy(p["offset"])
    if conditional:
        got = port_ops.cond_layernorm(xt, torch.from_numpy(labels), scale, offset)
    else:
        got = port_ops.layernorm(xt, scale, offset)
    np.testing.assert_allclose(got.numpy(), nhwc_to_nchw(np.asarray(want)), atol=2e-5)


@pytest.mark.parametrize("conditional,acgan", ARMS, ids=ARM_IDS)
def test_fresh_params_with_layer_norm_equal_jax(conditional, acgan):
    """Seed 0: D's norms ``Discriminator.{2,3,4}.N{1,2}.offset/scale``
    ([C], or [10, C] for the conditional D) in the JAX order, and every
    value equal."""
    jcfg, pcfg = _cfgs(conditional, acgan)
    gen, disc = _jax_params(jcfg)
    theirs = {**gen, **disc}
    ours = port_resnet.init_params(pcfg, seed=0)
    assert list(ours) == list(theirs)
    for name, value in theirs.items():
        np.testing.assert_array_equal(ours[name], np.asarray(value), err_msg=name)
    shape = (10, DIM) if conditional and not acgan else (DIM,)
    assert ours["Discriminator.3.N2.scale"].shape == shape


@pytest.mark.parametrize("conditional,acgan", ARMS, ids=ARM_IDS)
def test_discriminator_with_layer_norm_matches_jax(conditional, acgan, monkeypatch):
    """A whole D with ``normalization_d``, trained norm values, the same
    dropout masks: rtol 1e-4 / atol 2e-5 on every output."""
    jcfg, pcfg = _cfgs(conditional, acgan)
    _, disc = _jax_params(jcfg, seed=4)
    draws = JaxDraws(monkeypatch)
    rng = np.random.default_rng(5)
    for name in list(disc):
        if name.endswith((".scale", ".offset")):
            base = 1.0 if name.endswith(".scale") else 0.0
            disc[name] = jnp.asarray(rng.normal(base, 0.3, size=disc[name].shape).astype(np.float32))
    real = rng.uniform(-1, 1, size=(BATCH, 3072)).astype(np.float32)
    labels = rng.integers(0, 10, size=(BATCH,)).astype(np.int32)
    with apply_context(disc):
        want = jax_resnet.discriminator(jnp.asarray(real), jnp.asarray(labels), *KP, jcfg)
    rand = draws.injected()
    got = port_resnet.discriminator(to_port(disc, False), torch.from_numpy(real),
                                    torch.from_numpy(labels).long(), KP, pcfg, rand)
    assert rand.exhausted()
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=2e-5)


def test_disc_loss_grads_with_layer_norm_match_jax(monkeypatch):
    """The flagship's critic loss with ``normalization_d`` (the GP's double
    backward runs through six layer norms): the cost to 1e-4 relative and
    every D gradient to 1e-3 of its tensor's scale, as
    ``tests/test_torch_models.py`` holds the loss without them."""
    jcfg, pcfg = _cfgs(True, True)
    gen, disc = _jax_params(jcfg, seed=6)
    draws = JaxDraws(monkeypatch)
    rng = np.random.default_rng(6)
    real = rng.uniform(-1, 1, size=(BATCH, 3072)).astype(np.float32)
    labels = rng.integers(0, 10, size=(BATCH,)).astype(np.int32)
    _, step_fn, *_ = make_acgan_trainer(
        lambda n, lab, noise=None: jax_resnet.generator(n, lab, noise=noise, cfg=jcfg),
        lambda x, lab, k1, k2, k3: jax_resnet.discriminator(x, lab, k1, k2, k3, jcfg),
        JaxAcganConfig(batch_size=BATCH, critic_iters=2, iters=4),
    )
    (cost, _), grads = jax.jit(step_fn.pieces["disc_grad"])(
        disc, gen, jnp.asarray(real), jnp.asarray(labels), jax.random.PRNGKey(9))
    trainer = AcganTrainer(
        lambda p, n, lab, rand, noise=None: port_resnet.generator(p, n, lab, pcfg, rand, noise=noise),
        lambda p, x, lab, kps, rand: port_resnet.discriminator(p, x, lab, kps, pcfg, rand),
        AcganConfig(batch_size=BATCH, critic_iters=2, iters=4),
    )
    rand = InjectedRandomness(masks=draws.masks(), noises=draws.noises, gp_keys=draws.stream_keys["gp"])
    dp = to_port(disc)
    p_cost, _ = trainer.disc_loss(dp, to_port(gen), torch.from_numpy(real), torch.from_numpy(labels).long(),
                                  rand)
    assert rand.exhausted()
    p_grads = dict(zip(dp, torch.autograd.grad(p_cost, list(dp.values()))))
    np.testing.assert_allclose(float(p_cost.detach()), float(cost), rtol=1e-4)
    assert_grads_close(grads, p_grads, "disc with layer norm")


@pytest.mark.parametrize("acgan,norm_d,warns", [
    (False, False, True), (False, True, False), (True, False, False),
])
def test_app_warns_for_a_conditional_d_that_ignores_its_labels(acgan, norm_d, warns, monkeypatch, capsys):
    """The JAX app's warning (``ctgan_tpu/apps/ct_gan_cifar_resnet.py:105-107``)
    for a conditional model with neither ACGAN nor a norm in D."""
    x, y = synthetic_images(64, 3, 32, seed=0)
    monkeypatch.setattr(app, "load_arrays", lambda *a, **k: {"train": (x, y), "test": (x, y)})
    cfg = app.Config(DIM_G=DIM, DIM_D=DIM, BATCH_SIZE=BATCH, N_CRITIC=2, ACGAN=acgan,
                     NORMALIZATION_D=norm_d)
    flagship = app.setup(cfg, "cpu")
    assert ("effectively unconditional" in capsys.readouterr().out) == warns
    assert ("Discriminator.2.N1.scale" in flagship.state.disc_params) == norm_d
