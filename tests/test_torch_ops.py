"""``ctgan_tpu_torch`` ops, losses, init and data against ``ctgan_tpu`` on
the CPU, op by op, with inputs made by NumPy from a seed.  JAX layouts
(NHWC, HWIO, ``[in, out]``) are converted at the edge of each test; fp32
both sides, so tolerances cover summation order only."""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ctgan_tpu.core import apply_context
from ctgan_tpu.data import cifar10 as jax_cifar10
from ctgan_tpu.data.iterator import DeviceSampler as JaxDeviceSampler
from ctgan_tpu.data.synthetic import synthetic_images as jax_synthetic_images
from ctgan_tpu.losses import gan as jax_gan
from ctgan_tpu.ops import conv as jax_conv
from ctgan_tpu.ops import dropout as jax_dropout
from ctgan_tpu.ops import init as jax_init
from ctgan_tpu.ops import linear as jax_linear  # the function
from ctgan_tpu.ops import norm as jax_norm
from ctgan_tpu.ops import pool as jax_pool

from ctgan_tpu_torch import ops
from ctgan_tpu_torch.data import DeviceSampler, load_train, synthetic_images
from ctgan_tpu_torch.losses import gan as port_gan
from ctgan_tpu_torch.ops import init as port_init

from test_real_format_data import write_cifar_fixture
from torch_parity import InjectedRandomness, nhwc_to_nchw


def _nchw(a):
    return torch.from_numpy(nhwc_to_nchw(np.asarray(a, np.float32)))


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


def _close(port: torch.Tensor, want, atol=1e-5, rtol=1e-5, nchw=True):
    got = port.detach().numpy()
    want = np.asarray(want)
    if nchw and got.ndim == 4:
        got = np.transpose(got, (0, 2, 3, 1))
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_linear(rng):
    x = rng.normal(size=(5, 7)).astype(np.float32)
    w = rng.normal(size=(7, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    with apply_context({"L.W": w, "L.b": b}):
        want = jax_linear("L", 7, 3, jnp.asarray(x))
    _close(ops.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b)), want)


@pytest.mark.parametrize("size,k,stride", [(8, 3, 1), (8, 1, 1), (8, 3, 2), (7, 3, 2), (8, 4, 2)])
def test_conv2d_same_padding(rng, size, k, stride):
    """TF SAME: at stride 2 on an even input the bottom/right pad is one
    more than the top/left; F.conv2d(padding='same') refuses stride 2."""
    x = rng.normal(size=(2, size, size, 4)).astype(np.float32)
    w = rng.normal(size=(k, k, 4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    with apply_context({"C.Filters": w, "C.Biases": b}):
        want = jax_conv.conv2d("C", 4, 6, k, jnp.asarray(x), stride=stride)
    got = ops.conv2d(_nchw(x), _oihw(w), torch.from_numpy(b), stride=stride)
    assert got.shape[-1] == -(-size // stride)
    _close(got, want, atol=1e-4)


@pytest.mark.parametrize("k", [1, 3])
def test_conv_mean_pool2d(rng, k):
    """Fused stride-2 form against the JAX fused form (atol 1e-4) and
    against the port's own conv + mean pool (atol 1e-5)."""
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    w = rng.normal(size=(k, k, 4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    with apply_context({"C.Filters": w, "C.Biases": b}):
        want = jax_conv.conv_mean_pool2d("C", 4, 6, k, jnp.asarray(x))
    args = (_nchw(x), _oihw(w), torch.from_numpy(b))
    fused = ops.conv_mean_pool2d(*args)
    _close(fused, want, atol=1e-4)
    _close(fused, ops.mean_pool(ops.conv2d(*args)).numpy(), nchw=False)


@pytest.mark.parametrize("k", [1, 3])
def test_mean_pool_conv2d(rng, k):
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    w = rng.normal(size=(k, k, 4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    with apply_context({"C.Filters": w, "C.Biases": b}):
        want = jax_conv.mean_pool_conv2d("C", 4, 6, k, jnp.asarray(x))
    xt, wt, bt = _nchw(x), _oihw(w), torch.from_numpy(b)
    fused = ops.mean_pool_conv2d(xt, wt, bt)
    _close(fused, want, atol=1e-4)
    _close(fused, ops.conv2d(ops.mean_pool(xt), wt, bt).numpy(), nchw=False)


def test_fused_convs_reject_what_the_rewrite_cannot_take(rng):
    x = torch.zeros(1, 2, 7, 7)
    with pytest.raises(ValueError, match="even spatial"):
        ops.conv_mean_pool2d(x, torch.zeros(2, 2, 3, 3))
    with pytest.raises(ValueError, match="odd filter_size"):
        ops.mean_pool_conv2d(torch.zeros(1, 2, 8, 8), torch.zeros(2, 2, 2, 2))


def test_pools(rng):
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    _close(ops.mean_pool(_nchw(x)), jax_pool.mean_pool(jnp.asarray(x)))
    _close(ops.upsample_nearest(_nchw(x)), jax_pool.upsample_nearest(jnp.asarray(x)), atol=0, rtol=0)
    _close(ops.global_mean_pool(_nchw(x)), jax_pool.global_mean_pool(jnp.asarray(x)))


def test_batchnorm(rng):
    x = (3 + 2 * rng.normal(size=(4, 4, 4, 5))).astype(np.float32)
    scale = rng.normal(size=(5,)).astype(np.float32)
    offset = rng.normal(size=(5,)).astype(np.float32)
    with apply_context({"N.scale": scale, "N.offset": offset}):
        want = jax_norm.batchnorm("N", jnp.asarray(x))
    got = ops.batchnorm(_nchw(x), torch.from_numpy(scale), torch.from_numpy(offset))
    _close(got, want, atol=2e-5)


def test_cond_batchnorm(rng):
    x = (1 + rng.normal(size=(6, 4, 4, 5))).astype(np.float32)
    labels = rng.integers(0, 3, size=(6,))
    scale = rng.normal(size=(3, 5)).astype(np.float32)
    offset = rng.normal(size=(3, 5)).astype(np.float32)
    with apply_context({"N.scale": scale, "N.offset": offset}):
        want = jax_norm.cond_batchnorm("N", jnp.asarray(x), jnp.asarray(labels), 3)
    got = ops.cond_batchnorm(_nchw(x), torch.from_numpy(labels), torch.from_numpy(scale),
                             torch.from_numpy(offset))
    _close(got, want, atol=2e-5)


@pytest.mark.parametrize("kp", [0.8, 0.5])
def test_dropout_with_the_same_mask(rng, kp):
    """TF semantics, keep iff u < kp and scale 1/kp: equal bit for bit to
    the JAX dropout given the same mask."""
    x = rng.normal(size=(3, 4, 4, 5)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jax_dropout(jnp.asarray(x), kp, key=key)
    keep = np.asarray(jax.random.uniform(key, x.shape, jnp.float32) < kp)
    got = ops.dropout(_nchw(x), kp, InjectedRandomness(masks=[(keep, kp)]))
    _close(got, want, atol=0, rtol=0)


def test_dropout_keep_one_is_identity():
    x = torch.randn(2, 3, 4, 4)
    assert ops.dropout(x, 1.0, masks=None) is x


def test_init_draws_match_jax():
    """Same NumPy stream, same values."""
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    assert port_init.conv_filter_stdev(3, 8, 3) == jax_init.conv_filter_stdev(3, 8, 3)
    assert port_init.conv_filter_stdev(3, 8, 1, he_init=False) == jax_init.conv_filter_stdev(3, 8, 1, he_init=False)
    np.testing.assert_array_equal(port_init.uniform_stdev(a, 0.3, (4, 5)), jax_init.uniform_stdev(b, 0.3, (4, 5)))
    np.testing.assert_array_equal(port_init.linear_initializer(a, 6, 2),
                                  jax_init.linear_initializer(b, 6, 2, None))


def test_wgan_ct_acgan_losses(rng):
    d_real, d_real_2, d_fake = (rng.normal(size=(6,)).astype(np.float32) for _ in range(3))
    f1, f2 = (rng.normal(size=(6, 8)).astype(np.float32) for _ in range(2))
    logits = rng.normal(size=(6, 10)).astype(np.float32)
    labels = rng.integers(0, 10, size=(6,))
    t = torch.from_numpy
    for ours, theirs in zip(port_gan.wgan_losses(t(d_real), t(d_fake)),
                            jax_gan.wgan_losses(jnp.asarray(d_real), jnp.asarray(d_fake))):
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)
    for m in (0.0, 0.3):
        np.testing.assert_allclose(
            float(port_gan.consistency_term(t(d_real), t(d_real_2), t(f1), t(f2), lambda_2=2.0, factor_m=m)),
            float(jax_gan.consistency_term(d_real, d_real_2, f1, f2, lambda_2=2.0, factor_m=m)), rtol=1e-6)
    np.testing.assert_allclose(float(port_gan.acgan_loss(t(logits), t(labels))),
                               float(jax_gan.acgan_loss(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)
    assert float(port_gan.acgan_accuracy(t(logits), t(labels))) == float(
        jax_gan.acgan_accuracy(jnp.asarray(logits), jnp.asarray(labels)))


def test_gradient_penalty_and_its_double_backward(rng):
    """GP of a small tanh network on flat inputs: the penalty, and its
    gradient by the network's weights (through the input gradient), agree
    to rtol 1e-5."""
    real = rng.normal(size=(4, 6)).astype(np.float32)
    fake = rng.normal(size=(4, 6)).astype(np.float32)
    w1 = rng.normal(size=(6, 5)).astype(np.float32)
    w2 = rng.normal(size=(5,)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    alpha = np.array(jax.random.uniform(key, (4, 1), jnp.float32))

    def jax_gp(w1_, w2_):
        return jax_gan.gradient_penalty(lambda x: (jnp.tanh(x @ w1_) @ w2_, None), real, fake, key)[0]

    want, (gw1, gw2) = jax.value_and_grad(jax_gp, argnums=(0, 1))(jnp.asarray(w1), jnp.asarray(w2))
    tw1, tw2 = torch.tensor(w1, requires_grad=True), torch.tensor(w2, requires_grad=True)
    got, slopes = port_gan.gradient_penalty(lambda x: torch.tanh(x @ tw1) @ tw2, torch.from_numpy(real),
                                            torch.from_numpy(fake), torch.from_numpy(alpha))
    got.backward()
    assert slopes.shape == (4,)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(tw1.grad.numpy(), np.asarray(gw1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw2.grad.numpy(), np.asarray(gw2), rtol=1e-5, atol=1e-6)


def test_synthetic_images_equal_jax():
    for a, b in zip(synthetic_images(40, 3, 32, seed=9), jax_synthetic_images(40, 3, 32, seed=9)):
        np.testing.assert_array_equal(a, b)
    images, labels = load_train(None, n_examples=24)
    assert images.shape == (24, 3072) and images.dtype == np.uint8
    assert labels.shape == (24,) and labels.min() >= 0 and labels.max() < 10


def test_cifar_files_load_as_in_jax(tmp_path):
    write_cifar_fixture(str(tmp_path), n_per_batch=6)
    want = jax_cifar10.load_arrays(str(tmp_path), n_examples=20)["train"]
    got = load_train(str(tmp_path), n_examples=20)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (20, 3072) and got[0].dtype == np.uint8


def test_device_sampler_with_the_jax_permutation():
    """Given JAX's epoch permutation, the same [K, B, ...] batches; the
    port's own permutation is a seeded permutation, the same every time."""
    images, labels = synthetic_images(50, 3, 32, seed=1)
    jax_s = JaxDeviceSampler([images, labels.astype(np.int32)], 4, 3, seed=2)
    ours = DeviceSampler([images, labels], 4, 3, seed=2, device="cpu")
    assert ours.iters_per_epoch == jax_s.iters_per_epoch == 4
    for step in (0, 3, 5):
        perm = jax_s.host_perm(step)
        want = jax_s.sample(jnp.asarray(step), perm=perm)
        got = ours.sample(step, perm=torch.from_numpy(np.array(perm)).long())
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    perm = ours.epoch_perm(1)
    assert torch.equal(torch.sort(perm).values, torch.arange(50))
    again = DeviceSampler([images, labels], 4, 3, seed=2, device="cpu")
    assert torch.equal(again.epoch_perm(1), perm) and not torch.equal(again.epoch_perm(0), perm)
