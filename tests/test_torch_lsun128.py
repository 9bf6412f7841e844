"""The 128 px LSUN model of ``ctgan_tpu_torch`` and its blocks against
``ctgan_tpu``'s on the CPU: ``depth_to_space``, ``subpixel_conv``,
``scaled_upsample_conv``, ``residual_block_stride`` up, down and at one
width, ``upsample_conv2d`` against the plain path, ``lsun128`` parameter
creation (bit for bit), G, D (JAX's dropout masks injected,
tests/torch_parity.py) and D's input gradient, and one whole trainer
iteration with 2 critic iterations.

Widths 8-32, batch 3 (the trainer: 2); 128 px is fixed by the model.

Tolerances, each relative to the largest magnitude of the reference, fp32
on both sides: 1e-5 for outputs and input gradients (the two sum in other
orders; a D is about 20 layers deep); ``depth_to_space`` is a permutation
and must be exact.  The
trainer iteration holds the tolerances of tests/test_torch_gan_trainer.py.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ctgan_tpu.core import apply_context, init_context, rng_context, split_params
from ctgan_tpu.models import blocks as jax_blocks
from ctgan_tpu.models import lsun128 as jax_lsun128
from ctgan_tpu import ops as jax_ops
from ctgan_tpu.ops import conv as jax_conv
from ctgan_tpu.ops import pool as jax_pool
from ctgan_tpu.train import GanConfig as JaxGanConfig
from ctgan_tpu.train import make_gan_trainer

from ctgan_tpu_torch import ops as port_ops
from ctgan_tpu_torch.core.store import ParamInit
from ctgan_tpu_torch.models import blocks as port_blocks
from ctgan_tpu_torch.models import lsun128 as port_lsun128
from ctgan_tpu_torch.train import GanConfig, GanTrainer

from test_torch_gan_trainer import _assert_update_close, _port_state, _step_bound
from torch_parity import InjectedRandomness, JaxDraws, nhwc_to_nchw, to_port

TINY = dict(dim_g_4=32, dim_g_8=16, dim_g_16=8, dim_g_32=8, dim_g_64=8, dim_d_64=8, dim_d_32=8, dim_d_16=16,
            dim_d_8=32)
PORT_CFG = port_lsun128.Lsun128Config(**TINY)
JAX_CFG = jax_lsun128.Lsun128Config(**TINY)
BATCH = 3
RTOL = 1e-5
KP = port_lsun128.KP


def _np(t) -> np.ndarray:
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _max_dev(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _nchw(a) -> np.ndarray:
    return nhwc_to_nchw(np.asarray(a))


# ------------------------------------------------------------------ ops and blocks


def test_depth_to_space_equals_jax_and_is_not_pixel_shuffle():
    """TF orders the channels ``(i * r + j) * C + c``; ``F.pixel_shuffle``
    reads ``c * r * r + i * r + j``, which differs at C > 1."""
    x = np.random.default_rng(0).normal(size=(2, 3, 4, 5 * 4)).astype(np.float32)  # NHWC, C = 5
    want = _nchw(jax_pool.depth_to_space(jnp.asarray(x), 2))
    got = port_ops.depth_to_space(torch.from_numpy(_nchw(x)), 2)
    assert got.shape == (2, 5, 6, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(torch.nn.functional.pixel_shuffle(torch.from_numpy(_nchw(x)), 2).numpy(), want)


def _jax_block(make, seed: int = 0):
    """The params that ``make()`` creates under ``init_context(seed)``."""
    with init_context(seed=seed) as ctx:
        make()
    return dict(ctx.params)


def _port_norm(p, kind):
    if kind == "layer":
        return lambda name, x, labels: port_ops.layernorm(x, p[name + ".scale"], p[name + ".offset"])
    return lambda name, x, labels: port_ops.batchnorm(x, p[name + ".scale"], p[name + ".offset"])


def _jax_norm(kind):
    if kind == "layer":
        return lambda name, x, labels=None: jax_ops.layernorm(name, x)
    return lambda name, x, labels=None: jax_ops.batchnorm(name, x)


def _check_forward_and_input_grad(jax_fn, port_fn, x_nhwc: np.ndarray, jparams: dict):
    """``jax_fn(x)`` under the params against ``port_fn(p, x)``, and the
    input gradient of the output weighted by a fixed random tensor."""
    with apply_context(jparams):
        want = np.asarray(jax_fn(jnp.asarray(x_nhwc)))
    weights = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)

    def loss(x):
        with apply_context(jparams):
            return jnp.sum(jax_fn(x) * weights)

    want_grad = _nchw(jax.grad(loss)(jnp.asarray(x_nhwc)))
    p = to_port(jparams, requires_grad=False)
    x = torch.from_numpy(_nchw(x_nhwc)).requires_grad_(True)
    out = port_fn(p, x)
    (grad,) = torch.autograd.grad((out * torch.from_numpy(_nchw(weights))).sum(), [x])
    assert out.shape == _nchw(want).shape
    assert _max_dev(out, _nchw(want)) <= RTOL
    assert _max_dev(grad, want_grad) <= RTOL


def test_subpixel_and_scaled_upsample_convs_equal_jax():
    """The 1x1 subpixel conv (a conv to 4x the channels, depth-to-space) and
    the scaled upsample conv (its filter drawn with gain 0.5), forward and
    input gradient; their parameters as ``ParamInit`` creates them."""
    x = np.random.default_rng(2).normal(size=(BATCH, 6, 6, 8)).astype(np.float32)
    cases = [
        (lambda v: jax_blocks.subpixel_conv("S", 8, 5, 1, v, he_init=False),
         lambda p, v: port_blocks.subpixel_conv(p, "S", v),
         lambda init: init.conv("S", 8, 20, 1, he_init=False)),
        (lambda v: jax_blocks.scaled_upsample_conv("U", 8, 5, 3, v),
         lambda p, v: port_blocks.upsample_conv(p, "U", v),
         lambda init: port_blocks.scaled_upsample_conv_params(init, "U", 8, 5, 3)),
    ]
    for jax_fn, port_fn, make_params in cases:
        jparams = _jax_block(lambda: jax_fn(jnp.asarray(x)), seed=3)
        init = ParamInit(3)
        make_params(init)
        assert list(init.params) == list(jparams)
        for k, v in jparams.items():
            np.testing.assert_array_equal(init.params[k], np.asarray(v), err_msg=k)
        _check_forward_and_input_grad(jax_fn, port_fn, x, jparams)


@pytest.mark.parametrize("resample,cin,cout,norm", [
    ("up", 16, 8, "batch"), ("down", 8, 16, "layer"), (None, 16, 16, "layer"), (None, 8, 16, "batch"),
])
def test_residual_block_stride_equals_jax(resample, cin, cout, norm):
    """Forward and input gradient, and the parameters in the JAX block's
    creation order (Shortcut, N1, Conv1, N2, Conv2).  "down" has the
    stride-2 3x3 conv whose TF SAME padding is (0, 1) on an even input."""
    size = 4 if resample == "up" else 8
    x = np.random.default_rng(4).normal(size=(BATCH, size, size, cin)).astype(np.float32)
    jax_fn = lambda v: jax_blocks.residual_block_stride("B", cin, cout, 3, v, resample=resample,
                                                         normalize=_jax_norm(norm))
    jparams = _jax_block(lambda: jax_fn(jnp.asarray(x)), seed=5)
    init = ParamInit(5)
    port_blocks.residual_block_stride_params(init, "B", input_dim=cin, output_dim=cout, filter_size=3,
                                             resample=resample, norm=init.norm)
    assert list(init.params) == list(jparams)
    for k, v in jparams.items():
        np.testing.assert_array_equal(init.params[k], np.asarray(v), err_msg=k)
    port_fn = lambda p, v: port_blocks.residual_block_stride(
        p, "B", v, input_dim=cin, output_dim=cout, resample=resample, normalize=_port_norm(p, norm),
        fuse_meanpool=False)
    _check_forward_and_input_grad(jax_fn, port_fn, x, jparams)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_upsample_conv2d_equals_the_plain_path_and_jax(k):
    """The parity-collapsed conv on the small grid against the conv of the
    nearest upsample (port), and against JAX's ``upsample_conv2d`` on the
    same filter, forward and input gradient."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(BATCH, 5, 6, 4)).astype(np.float32)
    jax_fn = lambda v: jax_conv.upsample_conv2d("C", 4, 6, k, v)
    jparams = _jax_block(lambda: jax_fn(jnp.asarray(x)), seed=k)
    jparams = {n: v + 0.1 if n.endswith("Biases") else v for n, v in jparams.items()}
    _check_forward_and_input_grad(jax_fn, lambda p, v: port_ops.upsample_conv2d(v, p["C.Filters"], p["C.Biases"]),
                                  x, jparams)
    p = to_port(jparams, requires_grad=False)
    small = torch.from_numpy(_nchw(x))
    plain = port_ops.conv2d(port_ops.upsample_nearest(small), p["C.Filters"], p["C.Biases"])
    fused = port_ops.upsample_conv2d(small, p["C.Filters"], p["C.Biases"])
    assert fused.shape == plain.shape == (BATCH, 6, 10, 12)
    assert _max_dev(fused, plain) <= RTOL
    with pytest.raises(ValueError, match="odd filter_size"):
        port_ops.upsample_conv2d(small, torch.zeros(6, 4, 2, 2))


# ------------------------------------------------------------------ the model


def jax_params(seed: int = 0, cfg=JAX_CFG) -> dict:
    """The JAX app's creation: G on 2 noises, then D on G's images."""
    with init_context(seed=seed) as ctx:
        with rng_context(jax.random.PRNGKey(seed)):
            jax_lsun128.lsun128_discriminator(jax_lsun128.lsun128_generator(2, cfg=cfg), cfg=cfg,
                                              deterministic=True)
    return dict(ctx.params)


@pytest.mark.parametrize("norms", [(True, True), (False, False)])
def test_init_params_equal_init_context_bit_for_bit(norms):
    """Names in creation order (G, then D), shapes and every value; without
    norms the norm parameters are not created."""
    kw = dict(normalization_g=norms[0], normalization_d=norms[1])
    want = jax_params(7, jax_lsun128.Lsun128Config(**TINY, **kw))
    got = port_lsun128.init_params(port_lsun128.Lsun128Config(**TINY, **kw), 7)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    assert ("Generator.4_3.N1.scale" in got) == norms[0]
    assert got["Generator.Output.Filters"].shape == (5, 5, 8, 3)
    assert got["Discriminator.Input.Filters"].shape == (5, 5, 3, 8)
    assert set(port_lsun128.zero_grad_params(PORT_CFG)) <= set(got)


def test_full_width_names_and_shapes():
    """The defaults: 1024 channels at G's 4 px and D's 8 px, no shortcut in
    D's two 8 px blocks."""
    got = port_lsun128.init_params(seed=0)
    assert got["Generator.Input.W"].shape == (128, 4 * 4 * 1024)
    assert got["Discriminator.8_2.Conv2.Filters"].shape == (3, 3, 1024, 1024)
    assert "Discriminator.8_1.Shortcut.Filters" not in got and "Discriminator.16_3.Shortcut.Filters" in got
    assert got["Discriminator.Output.W"].shape == (1024, 1)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    real = rng.uniform(-1, 1, size=(BATCH, 3 * 128 * 128)).astype(np.float32)
    noise = rng.normal(size=(BATCH, 128)).astype(np.float32)
    return real, noise


def test_generator_equals_jax(batch):
    params = jax_params(1)
    gen, _, _ = split_params(params, "Generator", "Discriminator")
    _, noise = batch
    with rng_context(jax.random.PRNGKey(0)), apply_context(gen):
        want = jax_lsun128.lsun128_generator(BATCH, jnp.asarray(noise), cfg=JAX_CFG)
    got = port_lsun128.generator(to_port(gen, False), BATCH, None, cfg=PORT_CFG, noise=torch.from_numpy(noise))
    assert got.shape == (BATCH, 3 * 128 * 128) and got.dtype == torch.float32
    assert _max_dev(got, want) <= RTOL


@pytest.mark.parametrize("kps", [KP, (1.0, 1.0, 1.0)])
def test_discriminator_and_its_input_gradient_equal_jax(batch, kps, monkeypatch):
    """Logits and pooled features against the JAX D with the same masks (3
    per pass, ``[N, 32, 8, 8]`` here), and the input gradient of the
    logits' sum (what the gradient penalty differentiates)."""
    _, disc, _ = split_params(jax_params(2), "Generator", "Discriminator")
    draws = JaxDraws(monkeypatch, model=jax_lsun128)
    real, _ = batch

    def jax_d(x):
        with apply_context(disc):
            return jax_lsun128.lsun128_discriminator(x, *kps, cfg=JAX_CFG)

    def summed(x):
        out = jax_d(x)
        return jnp.sum(out[0]), out

    want_grad, want = jax.grad(summed, has_aux=True)(jnp.asarray(real))  # one trace: one set of masks
    assert [s for _, s, _ in draws.dropouts] == ([(BATCH, 8, 8, 32)] * 3 if kps == KP else [])
    masks = draws.masks()
    x = torch.from_numpy(real).requires_grad_(True)
    rand = InjectedRandomness(masks=masks)
    got = port_lsun128.discriminator(to_port(disc, False), x, rand, cfg=PORT_CFG, kps=kps)
    assert rand.exhausted()
    assert got[0].shape == (BATCH,) and got[1].shape == (BATCH, 32)
    for g, w in zip(got, want):
        assert _max_dev(g, w) <= RTOL
    (grad,) = torch.autograd.grad(got[0].sum(), [x])
    assert _max_dev(grad, want_grad) <= RTOL


def test_one_trainer_iteration_equals_jax(monkeypatch):
    """The JAX package's whole ``step_fn`` (G substep, then 2 critic
    substeps; wgan-CT, beta1 0, linear decay, as the LSUN app) jitted, at
    step 0 and again at step 1, against ``GanTrainer.step`` from the same
    state with JAX's draws: G's and D's params and moments with the
    tolerances of tests/test_torch_gan_trainer.py, the last critic
    substep's metrics to rtol 1e-4."""
    n_critic, batch = 2, 2
    params = {k: jnp.asarray(v) for k, v in port_lsun128.init_params(PORT_CFG, 5).items()}
    gen, disc, _ = split_params(params, "Generator", "Discriminator")
    draws = JaxDraws(monkeypatch, model=jax_lsun128)
    extra = dict(mode="wgan-CT", batch_size=batch, critic_iters=n_critic, lambda_ct=2.0, beta1=0.0,
                 lr_decay=True, iters=10)
    init_state, step_fn, _, _ = make_gan_trainer(
        lambda n, noise=None: jax_lsun128.lsun128_generator(n, noise, cfg=JAX_CFG),
        lambda x: jax_lsun128.lsun128_discriminator(x, *KP, cfg=JAX_CFG), JaxGanConfig(**extra))
    trainer = GanTrainer(
        lambda p, n, rand, noise=None: port_lsun128.generator(p, n, rand, cfg=PORT_CFG, noise=noise),
        lambda p, x, rand: port_lsun128.discriminator(p, x, rand, cfg=PORT_CFG), GanConfig(**extra))
    real = np.random.default_rng(7).uniform(-1, 1, size=(n_critic, batch, 3 * 128 * 128)).astype(np.float32)
    jstep = jax.jit(step_fn)
    key = jax.random.PRNGKey(11)
    states = [init_state(gen, disc)]
    for _ in range(2):
        states.append(jstep(states[-1], jnp.asarray(real), key)[0])
    assert len(draws.dropouts) == 3 * (1 + 4 * n_critic)  # traced once: each step draws the same
    zero_grad, bound = port_lsun128.zero_grad_params(PORT_CFG), _step_bound(trainer)
    for step in (0, 1):
        rand = draws.injected()
        state = _port_state(states[step])
        got = trainer.step(state, torch.from_numpy(real), rand)
        assert rand.exhausted() and state.step == step + 1
        want = jstep(states[step], jnp.asarray(real), key)[1]
        assert set(got) == set(want) | {"gen_cost"}
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
        after = states[step + 1]
        _assert_update_close(state.gen_params, state.gen_opt, after.gen_params, after.gen_opt, zero_grad, bound,
                             step)
        _assert_update_close(state.disc_params, state.disc_opt, after.disc_params, after.disc_opt, zero_grad,
                             bound, n_critic)
