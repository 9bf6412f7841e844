"""The 64 px app's ``ARCH resnet101`` of ``ctgan_tpu_torch`` against
``ctgan_tpu``'s on the CPU: the TF-SAME 3x3 transposed conv, the bottleneck
block up, down and at one width (forward, input gradient, parameters in
the JAX block's creation order), the 101-layer G and D at dim 16 (as
``tests/test_models.py`` builds them; parameters bit for bit), and the app
training it, with no dropout and so no mask drawn.

Tolerances, relative to the largest magnitude of the reference, fp32 on
both sides: 1e-5 for a block, a transposed conv and their input
gradients; 1e-4 for the whole G and D, each 33 bottleneck blocks (about
140 convs and norms) deep, whose sums run in other orders in the two
packages.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ctgan_tpu.core import apply_context, init_context, rng_context, split_params
from ctgan_tpu.models import blocks as jax_blocks
from ctgan_tpu.models import good64 as jax_good64
from ctgan_tpu import ops as jax_ops
from ctgan_tpu.ops import conv as jax_conv

from ctgan_tpu_torch import ops as port_ops
from ctgan_tpu_torch.apps import ct_gan_64x64 as app
from ctgan_tpu_torch.core import Randomness
from ctgan_tpu_torch.core.store import ParamInit
from ctgan_tpu_torch.data.synthetic import synthetic_images
from ctgan_tpu_torch.models import blocks as port_blocks
from ctgan_tpu_torch.models import good64 as port_good64

from torch_parity import nhwc_to_nchw, to_port

DIM, BATCH = 16, 2
BLOCK_RTOL, MODEL_RTOL = 1e-5, 1e-4


def _np(t) -> np.ndarray:
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _max_dev(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _nchw(a) -> np.ndarray:
    return nhwc_to_nchw(np.asarray(a))


def _forward_and_input_grad(jax_fn, port_fn, x_nhwc: np.ndarray, jparams: dict) -> tuple[float, float]:
    """Deviations of ``port_fn(p, x)`` from ``jax_fn(x)`` and of the input
    gradient of their outputs weighted by a fixed random tensor."""
    weights = None

    def loss(x):
        with apply_context(jparams):
            out = jax_fn(x)
        return jnp.sum(out * weights), out

    with apply_context(jparams):
        weights = np.random.default_rng(1).normal(size=jax_fn(jnp.asarray(x_nhwc)).shape).astype(np.float32)
    want_grad, want = jax.grad(loss, has_aux=True)(jnp.asarray(x_nhwc))
    x = torch.from_numpy(_nchw(x_nhwc)).requires_grad_(True)
    out = port_fn(to_port(jparams, requires_grad=False), x)
    (grad,) = torch.autograd.grad((out * torch.from_numpy(_nchw(weights))).sum(), [x])
    assert out.shape == _nchw(want).shape
    return _max_dev(out, _nchw(want)), _max_dev(grad, _nchw(want_grad))


@pytest.mark.parametrize("k,h", [(3, 4), (3, 7), (5, 4)])
def test_deconv2d_equals_jax_at_3x3_and_5x5(k, h):
    """TF's SAME stride-2 transposed conv: the 3x3 of the bottleneck "up"
    block pads (0, 1), the DCGAN family's 5x5 (1, 2)."""
    x = np.random.default_rng(k + h).normal(size=(BATCH, h, h, 6)).astype(np.float32)
    jax_fn = lambda v: jax_conv.deconv2d("T", 6, 4, k, v)
    with init_context(seed=k) as ctx:
        jax_fn(jnp.asarray(x))
    jparams = {n: v + 0.1 if n.endswith("Biases") else v for n, v in ctx.params.items()}
    dev = _forward_and_input_grad(jax_fn, lambda p, v: port_ops.deconv2d(v, p["T.Filters"], p["T.Biases"]),
                                  x, jparams)
    assert max(dev) <= BLOCK_RTOL, dev


@pytest.mark.parametrize("resample,cin,cout,size,norm", [
    ("up", 16, 8, 4, "batch"), ("down", 8, 16, 8, "layer"), (None, 16, 16, 4, "layer"),
])
def test_bottleneck_block_equals_jax(resample, cin, cout, size, norm):
    x = np.random.default_rng(3).normal(size=(BATCH, size, size, cin)).astype(np.float32)
    jax_norm = (lambda n, v, labels=None: jax_ops.layernorm(n, v)) if norm == "layer" else (
        lambda n, v, labels=None: jax_ops.batchnorm(n, v))
    jax_fn = lambda v: jax_blocks.bottleneck_residual_block("B", cin, cout, 3, v, resample=resample,
                                                            normalize=jax_norm)
    with init_context(seed=4) as ctx:
        jax_fn(jnp.asarray(x))
    jparams = dict(ctx.params)
    init = ParamInit(4)
    port_blocks.bottleneck_residual_block_params(init, "B", input_dim=cin, output_dim=cout, filter_size=3,
                                                 resample=resample, norm=init.norm)
    assert list(init.params) == list(jparams)
    for name, v in jparams.items():
        np.testing.assert_array_equal(init.params[name], np.asarray(v), err_msg=name)
    assert "B.Conv2.Biases" not in jparams
    op = port_ops.layernorm if norm == "layer" else port_ops.batchnorm

    def port_fn(p, v):
        return port_blocks.bottleneck_residual_block(
            p, "B", v, input_dim=cin, output_dim=cout, resample=resample,
            normalize=lambda n, u, labels: op(u, p[n + ".scale"], p[n + ".offset"]))

    dev = _forward_and_input_grad(jax_fn, port_fn, x, jparams)
    assert max(dev) <= BLOCK_RTOL, dev


@pytest.fixture(scope="module")
def jax_model():
    """The JAX package's fresh 101-layer G and D at dim 16 (seed 2), and
    G's images and D's logits on seeded noise."""
    noise = np.random.default_rng(5).normal(size=(BATCH, 128)).astype(np.float32)
    with init_context(seed=2) as ctx:
        with rng_context(jax.random.PRNGKey(0)):
            images = jax_good64.resnet101_64_generator(BATCH, jnp.asarray(noise), dim=DIM)
            logits, features = jax_good64.resnet101_64_discriminator(images, dim=DIM)
    return dict(ctx.params), noise, np.asarray(images), np.asarray(logits), np.asarray(features)


def test_resnet101_init_params_equal_jax_bit_for_bit(jax_model):
    want = jax_model[0]
    got = port_good64.resnet101_init_params(DIM, seed=2)
    assert list(got) == list(want)
    for name, v in want.items():
        np.testing.assert_array_equal(got[name], np.asarray(v), err_msg=name)
    assert sum(n.endswith(".Conv1B.Filters") for n in got) == 66


def test_resnet101_generator_and_discriminator_equal_jax(jax_model):
    """G's ``tanh(out / 5)`` images and D's logits (divided by 5) and
    NHWC-flattened features; D draws no mask."""
    params, noise, images, logits, features = jax_model
    gen, disc, _ = split_params(params, "Generator", "Discriminator")
    got = port_good64.resnet101_generator(to_port(gen, False), BATCH, None, dim=DIM, noise=torch.from_numpy(noise))
    assert got.shape == (BATCH, 3 * 64 * 64)
    assert _max_dev(got, images) <= MODEL_RTOL
    got_logits, got_features = port_good64.resnet101_discriminator(
        to_port(disc, False), torch.from_numpy(images.copy()), None, dim=DIM)
    assert got_logits.shape == (BATCH,) and got_features.shape == (BATCH, 4 * 4 * 8 * DIM)
    assert _max_dev(got_logits, logits) <= MODEL_RTOL
    assert _max_dev(got_features, features) <= MODEL_RTOL


def test_app_trains_resnet101_without_masks(tmp_path, monkeypatch):
    """Two iterations of ``ARCH resnet101`` (dim 16, batch 2, 2 critic
    iterations, the first 16 images of the pool): checkpoints, finite
    costs, and no mask asked for in any D pass."""
    monkeypatch.setattr(app, "synthetic_images", lambda n, c, s, n_classes=10, seed=1234: synthetic_images(
        16, c, s, n_classes, seed))

    def no_mask(*args, **kwargs):
        raise AssertionError("resnet101's D has no dropout")

    monkeypatch.setattr(Randomness, "dropout_mask", no_mask)
    cfg = app.Config(ARCH="resnet101", DIM=DIM, BATCH_SIZE=BATCH, CRITIC_ITERS=2, ITERS=2, save_every=2,
                     sample_every=2, inception_every=0, out_dir=str(tmp_path))
    state, records = app.main(cfg=cfg, device="cpu")
    assert state.step == 2 and (tmp_path / "ckpt" / "ckpt_2.npz").is_file() and (tmp_path / "samples_1.png").is_file()
    assert all(np.isfinite(r["disc_cost"]) and np.isfinite(r["gen_cost"]) for r in records)
    assert "Discriminator.4x4_5.BN.scale" in state.disc_params and "Generator.Out.Filters" in state.gen_params
