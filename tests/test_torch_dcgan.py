"""The DCGAN family of ``ctgan_tpu_torch`` against ``ctgan_tpu`` on the CPU:
the activations, the initialisation menu and override, ``deconv2d``, batch
norm of a linear output, parameter creation of every architecture, G and D
of MNIST, CIFAR-10 and the 64 px archs with JAX's dropout masks injected
(tests/torch_parity.py), and ``input_slopes``.

Tolerances, each relative to the largest magnitude of the reference:

* fp32, port against JAX: 1e-5 (other summation orders, a handful of
  layers; the 64 px archs at dim 8).
* ``deconv2d`` in bf16: 4 bf16 roundoffs (``U = 2**-8``) against JAX's
  bf16, the standard of tests/test_torch_bf16.py: the two round at the same
  points and sum in other orders.
* bf16 models: D 4 U against JAX's bf16 and 12 U against the fp32 port, as
  tests/test_torch_bf16.py holds the flagship's D (measured over seeds
  1-3: at most 2.03 U and 2.96 U).  G: 4 U against JAX without batch norm
  (MNIST wgan-CT: the linear, three transposed convs and the sigmoid round;
  1.64 U measured); with batch norm over a batch of 4 a rounding that lands
  the other way in one package carries into every later element (up to
  14.62 U in the deeper 64 px G, tests/test_torch_good64.py), so 8 U for
  CIFAR's G and MNIST's wgan G (2.25 U measured).  12 U against the fp32
  port (CIFAR's G, about ten roundings: 9.33 U measured).
"""

from __future__ import annotations

import functools
import gzip
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from ctgan_tpu import ops as jax_ops
from ctgan_tpu.core import apply_context, default_tpu_policy, init_context, rng_context
from ctgan_tpu.losses import gan as jax_losses
from ctgan_tpu.models import dcgan as jax_dcgan
from ctgan_tpu.models import fc as jax_fc
from ctgan_tpu.ops import init as jax_init

from ctgan_tpu_torch import ops as port_ops
from ctgan_tpu_torch.bridge import from_jax_params, to_jax_params
from ctgan_tpu_torch.core import default_policy, precision_policy
from ctgan_tpu_torch.core.store import ParamInit
from ctgan_tpu_torch.losses import input_slopes
from ctgan_tpu_torch.models import dcgan as port_dcgan
from ctgan_tpu_torch.models import fc as port_fc
from ctgan_tpu_torch.ops import init as port_init

from torch_parity import InjectedRandomness, JaxDraws, nhwc_to_nchw

U = 2.0 ** -8


@pytest.fixture(autouse=True)
def _fp32_after():
    yield
    default_policy(False)
    default_tpu_policy(False)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _max_dev(got, want) -> float:
    """Largest deviation over the largest magnitude of ``want``."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---------------------------------------------------------------- activations


def test_leaky_relu_and_its_gradient_at_zero_equal_jax():
    """``max(0.2 x, x)`` splits its gradient at the tie x = 0 (0.6), as
    ``jnp.maximum`` does; ``F.leaky_relu`` would give 0.2 there."""
    x = np.array([-2.0, -0.5, 0.0, 0.0, 0.3, 4.0], np.float32)
    want = jax.grad(lambda v: jnp.sum(jax_ops.leaky_relu(v)))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    y = port_ops.leaky_relu(t)
    (got,) = torch.autograd.grad(y.sum(), t)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jax_ops.leaky_relu(jnp.asarray(x))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)
    assert abs(float(got[2]) - 0.6) < 1e-6
    (theirs,) = torch.autograd.grad(F.leaky_relu(t, 0.2).sum(), t)
    assert abs(float(theirs[2]) - 0.2) < 1e-6


def test_gated_nonlinearity_equals_jax():
    a, b = np.random.default_rng(0).normal(size=(2, 3, 5)).astype(np.float32)
    want = jax_ops.gated_nonlinearity(jnp.asarray(a), jnp.asarray(b))
    got = port_ops.gated_nonlinearity(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- initialisation


@pytest.mark.parametrize("scheme", [None, "glorot", "he", "lecun", "glorot_he"])
def test_linear_initializer_menu_equals_jax(scheme):
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    np.testing.assert_array_equal(port_init.linear_initializer(a, 7, 3, scheme),
                                  jax_init.linear_initializer(b, 7, 3, scheme))


def test_initializer_refuses_what_is_not_ported():
    # the whole menu is ported ("orthogonal" too: tests/test_torch_ops_extra.py); an unknown scheme is refused
    with pytest.raises(ValueError, match="Invalid initialization"):
        port_init.linear_initializer(np.random.default_rng(0), 4, 4, "xavier")


def test_weights_stdev_override_equals_jax():
    """Draws inside nested overrides use the innermost stdev, in both
    packages, whatever the scheme asked for; outside, the scheme's."""
    a, b = np.random.default_rng(1), np.random.default_rng(1)
    outs = []
    for mod, rng in ((port_init, a), (jax_init, b)):
        draws = []
        with mod.WeightsStdevOverride(0.02):
            draws.append(mod.uniform_stdev(rng, 1.0, (5, 4)))
            with mod.WeightsStdevOverride(0.5):
                draws.append(mod.linear_initializer(rng, 6, 2, "he"))
            draws.append(mod.linear_initializer(rng, 6, 2, None))
        draws.append(mod.uniform_stdev(rng, 1.0, (3,)))
        outs.append(draws)
    for got, want in zip(*outs):
        np.testing.assert_array_equal(got, want)
    assert np.abs(outs[0][0]).max() <= 0.02 * np.sqrt(3) and port_init.WeightsStdevOverride.current() is None


@pytest.mark.parametrize("transposed", [False, True])
def test_conv_filter_stdev_equals_jax(transposed):
    for args in ((3, 8, 5, 2), (64, 32, 5, 2), (4, 4, 3, 1)):
        assert (port_init.conv_filter_stdev(*args, transposed=transposed)
                == jax_init.conv_filter_stdev(*args, transposed=transposed))


# (arch, mode) -> the JAX app's G and D at dim 8 (the 64 px archs' G/D pairs
# of ctgan_tpu/apps/ct_gan_64x64.py::pick_arch)
def _jax_nets(arch: str, mode: str, dim: int = 8):
    if arch == "mnist":
        return (functools.partial(jax_dcgan.mnist_generator, dim=dim, mode=mode),
                functools.partial(jax_dcgan.mnist_discriminator, dim=dim, mode=mode))
    if arch == "cifar":
        return (functools.partial(jax_dcgan.cifar_generator, dim=dim),
                functools.partial(jax_dcgan.cifar_discriminator, dim=dim, mode=mode))
    gen = {"dcgan": functools.partial(jax_dcgan.dcgan64_generator, dim=dim),
           "crippled": functools.partial(jax_dcgan.crippled_dcgan64_generator, dim=dim),
           "fc": functools.partial(jax_fc.fc_generator, output_dim=64 * 64 * 3),
           "multiplicative": functools.partial(jax_dcgan.multiplicative_dcgan64_generator, dim=dim)}[arch]
    disc = (jax_dcgan.multiplicative_dcgan64_discriminator if arch == "multiplicative"
            else jax_dcgan.dcgan64_discriminator)
    return gen, functools.partial(disc, dim=dim, mode=mode)


@functools.lru_cache(maxsize=None)
def jax_params(arch: str, mode: str, dim: int = 8, seed: int = 0) -> dict:
    """G then D, as the JAX app creates them: ``disc_fn(gen_fn(2))`` in
    ``init_context(seed)``."""
    gen, disc = _jax_nets(arch, mode, dim)
    with init_context(seed=seed) as ctx:
        with rng_context(jax.random.PRNGKey(seed)):
            disc(gen(2))
    return dict(ctx.params)


INIT_CASES = [("mnist", "wgan-CT"), ("mnist", "wgan"), ("cifar", "wgan-CT"), ("cifar", "wgan-ct"),
              ("dcgan", "wgan-ct"), ("dcgan", "dcgan"), ("crippled", "wgan-ct"), ("fc", "wgan-gp"),
              ("multiplicative", "wgan-ct")]


@pytest.mark.parametrize("arch,mode", INIT_CASES)
def test_init_params_equal_jax(arch, mode):
    """Names, order, shapes and values of every architecture's fresh
    parameters: batch norms where the mode puts them, the 0.02 override of
    the DCGAN models, "he" in the fc G, HWOI transposed-conv filters."""
    want = jax_params(arch, mode, seed=3)
    got = port_dcgan.init_params(arch, 8, mode, seed=3)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_zero_grad_params_name_real_parameters():
    for arch, mode in INIT_CASES:
        names = set(port_dcgan.init_params(arch, 8, mode))
        assert set(port_dcgan.zero_grad_params(arch, mode)) <= names, (arch, mode)
    assert "Discriminator.2.Biases" in port_dcgan.zero_grad_params("cifar", "wgan-ct")
    assert "Discriminator.2.Biases" not in port_dcgan.zero_grad_params("cifar", "wgan-CT")
    assert port_dcgan.zero_grad_params("mnist", "wgan-CT") == ["Discriminator.Output.b"]
    with pytest.raises(ValueError, match="unknown arch"):
        port_dcgan.init_params("resnet101", 8)


def test_fc_discriminator_params_and_forward_equal_jax():
    """``fc_discriminator``, which no app pairs with a G, at fc_dim 16."""
    with init_context(seed=2) as ctx:
        with rng_context(jax.random.PRNGKey(2)):
            jax_fc.fc_discriminator(jnp.zeros((2, 48)), input_dim=48, fc_dim=16, n_layers=2)
    init = ParamInit(2)
    port_fc.fc_discriminator_params(init, input_dim=48, fc_dim=16, n_layers=2)
    assert list(init.params) == list(ctx.params)
    x = np.random.default_rng(0).normal(size=(3, 48)).astype(np.float32)
    with apply_context(ctx.params):
        want = jax_fc.fc_discriminator(jnp.asarray(x), input_dim=48, fc_dim=16, n_layers=2)
    got = port_fc.fc_discriminator(from_jax_params(init.params), torch.from_numpy(x), n_layers=2)
    for g, w in zip(got, want):
        assert _max_dev(g, w) <= 1e-5


# ---------------------------------------------------------------- deconv2d


def _jax_deconv(x_nhwc, w_hwoi, b):
    with apply_context({"d.Filters": jnp.asarray(w_hwoi), "d.Biases": jnp.asarray(b)}):
        return jax_ops.deconv2d("d", w_hwoi.shape[3], w_hwoi.shape[2], w_hwoi.shape[0], jnp.asarray(x_nhwc))


def _deconv_inputs(h: int, cin: int = 6, cout: int = 3, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, h, h, cin)).astype(np.float32),
            rng.normal(size=(5, 5, cout, cin)).astype(np.float32) * 0.1,
            rng.normal(size=cout).astype(np.float32))


def _port_deconv(x_nhwc, w_hwoi, b):
    w = from_jax_params({"d.Filters": w_hwoi})["d.Filters"]
    assert tuple(w.shape) == (w_hwoi.shape[3], w_hwoi.shape[2], 5, 5)  # [in, out, kH, kW]
    return port_ops.deconv2d(torch.from_numpy(nhwc_to_nchw(x_nhwc)), w, torch.from_numpy(b))


@pytest.mark.parametrize("h", [4, 7])
def test_deconv2d_equals_jax(h):
    """Exactly 2H x 2W, within 1e-5 of JAX's scale at an even and an odd
    size (MNIST's 7 -> 14); the ``padding=2, output_padding=1`` form has
    the right shape and fails by a pixel's shift."""
    x, w, b = _deconv_inputs(h)
    want = nhwc_to_nchw(np.asarray(_jax_deconv(x, w, b)))
    got = _port_deconv(x, w, b)
    assert got.shape == (2, 3, 2 * h, 2 * h) and got.dtype == torch.float32
    assert _max_dev(got, want) <= 1e-5
    wt = from_jax_params({"d.Filters": w})["d.Filters"]
    shifted = F.conv_transpose2d(torch.from_numpy(nhwc_to_nchw(x)), wt, torch.from_numpy(b), stride=2, padding=2,
                                 output_padding=1)
    assert shifted.shape == got.shape and _max_dev(shifted, want) > 1e-1


def test_deconv2d_gradients_equal_jax():
    """Gradients of a weighted sum of the output with respect to the input
    and the filter (in the bridge's layout), within 1e-5 of JAX's scale."""
    x, w, b = _deconv_inputs(7, seed=1)
    cot = np.random.default_rng(2).normal(size=(2, 14, 14, 3)).astype(np.float32)
    jgx, jgw = jax.grad(lambda xx, ww: jnp.sum(_jax_deconv(xx, ww, b) * cot), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(nhwc_to_nchw(x)).requires_grad_(True)
    wt = from_jax_params({"d.Filters": w})["d.Filters"].requires_grad_(True)
    out = port_ops.deconv2d(xt, wt, torch.from_numpy(b))
    gx, gw = torch.autograd.grad((out * torch.from_numpy(nhwc_to_nchw(cot))).sum(), (xt, wt))
    assert _max_dev(gx, nhwc_to_nchw(np.asarray(jgx))) <= 1e-5
    assert _max_dev(to_jax_params({"d.Filters": gw})["d.Filters"], jgw) <= 1e-5


def test_deconv2d_bf16_equals_jax():
    """Under the bf16 policy: bf16 out, as JAX's, within 4 U; a bf16 input
    too."""
    x, w, b = _deconv_inputs(4, seed=3)
    default_tpu_policy(True)
    want = _jax_deconv(x, w, b)
    with precision_policy("bfloat16"):
        got = _port_deconv(x, w, b)
        from_bf16 = port_ops.deconv2d(torch.from_numpy(nhwc_to_nchw(x)).bfloat16(),
                                      from_jax_params({"d.Filters": w})["d.Filters"], torch.from_numpy(b))
    assert str(want.dtype) == "bfloat16" and got.dtype == torch.bfloat16 and from_bf16.dtype == torch.bfloat16
    want = nhwc_to_nchw(np.asarray(want, np.float32))
    assert _max_dev(got, want) <= 4 * U
    assert torch.equal(from_bf16, got)


def test_deconv2d_filter_round_trips_the_bridge():
    """An HWOI filter goes to ``[in, out, kH, kW]`` and back exactly (the
    bridge's ``.Filters`` rule), so a checkpoint's deconv filters move
    between the packages unchanged."""
    _, w, _ = _deconv_inputs(4)
    port = from_jax_params({"Generator.2.Filters": w})
    np.testing.assert_array_equal(port["Generator.2.Filters"].numpy(), np.transpose(w, (3, 2, 0, 1)))
    np.testing.assert_array_equal(to_jax_params(port)["Generator.2.Filters"], w)


def test_deconv2d_refuses_what_the_models_never_use():
    """Odd square filters at stride 2 only: the DCGAN family's 5x5 and the
    bottleneck block's 3x3 (tests/test_torch_resnet101.py)."""
    x = torch.zeros(1, 4, 4, 4)
    with pytest.raises(ValueError, match="odd square filters at stride 2"):
        port_ops.deconv2d(x, torch.zeros(4, 2, 4, 4))
    with pytest.raises(ValueError, match="odd square filters at stride 2"):
        port_ops.deconv2d(x, torch.zeros(4, 2, 5, 3))
    with pytest.raises(ValueError, match="odd square filters at stride 2"):
        port_ops.deconv2d(x, torch.zeros(4, 2, 5, 5), stride=1)


def test_batchnorm_of_a_linear_output_equals_jax():
    """Per-feature statistics of ``[N, F]`` (the generators' ``BN1``)."""
    rng = np.random.default_rng(5)
    x = (3.0 + rng.normal(size=(6, 10))).astype(np.float32)
    scale, offset = rng.uniform(0.5, 1.5, 10).astype(np.float32), rng.normal(size=10).astype(np.float32)
    with apply_context({"n.scale": jnp.asarray(scale), "n.offset": jnp.asarray(offset)}):
        want = jax_ops.batchnorm("n", jnp.asarray(x))
    got = port_ops.batchnorm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(offset))
    assert got.shape == (6, 10) and _max_dev(got, want) <= 1e-6


# ---------------------------------------------------------------- models


_CHW = {"mnist": (1, 28, 28), "cifar": (3, 32, 32)}


def _port_nets(arch: str, mode: str, dim: int):
    if arch in _CHW:
        gen = getattr(port_dcgan, f"{arch}_generator")
        disc = getattr(port_dcgan, f"{arch}_discriminator")
        g_kw = {"mode": mode} if arch == "mnist" else {}
        return (lambda p, n, rand, noise=None: gen(p, n, rand, dim=dim, noise=noise, **g_kw),
                lambda p, x, rand, keep_prob=0.5: disc(p, x, rand, dim=dim, mode=mode, keep_prob=keep_prob))
    gen = {"dcgan": port_dcgan.dcgan64_generator, "crippled": port_dcgan.crippled_dcgan64_generator,
           "multiplicative": port_dcgan.multiplicative_dcgan64_generator}.get(arch)
    disc = (port_dcgan.multiplicative_dcgan64_discriminator if arch == "multiplicative"
            else port_dcgan.dcgan64_discriminator)
    if gen is None:
        port_gen = lambda p, n, rand, noise=None: port_fc.fc_generator(p, n, rand, noise=noise)
    else:
        port_gen = lambda p, n, rand, noise=None: gen(p, n, rand, dim=dim, noise=noise)
    return port_gen, lambda p, x, rand, keep_prob=None: disc(p, x, rand, dim=dim, mode=mode)


def _run_generator(arch, mode, dim, params, noise):
    jax_gen, _ = _jax_nets(arch, mode, dim)
    with rng_context(jax.random.PRNGKey(0)), apply_context(params):
        want = jax_gen(len(noise), jnp.asarray(noise))
    port_gen, _ = _port_nets(arch, mode, dim)
    got = port_gen(from_jax_params({k: np.asarray(v) for k, v in params.items()}), len(noise), None,
                   noise=torch.from_numpy(noise))
    return got, want


def _gen_params(arch, mode, dim, seed):
    return {k: v for k, v in jax_params(arch, mode, dim, seed).items() if k.startswith("Generator")}


def _disc_params(arch, mode, dim, seed):
    return {k: v for k, v in jax_params(arch, mode, dim, seed).items() if k.startswith("Discriminator")}


MODEL_CASES = [("mnist", "wgan-CT", 64, 8), ("mnist", "wgan", 64, 8), ("cifar", "wgan-CT", 128, 4),
               ("cifar", "wgan-ct", 128, 4)]


@pytest.mark.parametrize("arch,mode,dim,batch", MODEL_CASES)
def test_generator_equals_jax(arch, mode, dim, batch):
    """Full width, fp32: the crop to 7x7, the sigmoid (MNIST) and tanh, G's
    NHWC reshape of its linear output, batch norm where the mode puts it."""
    noise = np.random.default_rng(1).normal(size=(batch, 128)).astype(np.float32)
    got, want = _run_generator(arch, mode, dim, _gen_params(arch, mode, dim, 1), noise)
    c, h, w = _CHW[arch]
    assert got.shape == (batch, c * h * w) and got.dtype == torch.float32
    lo = 0.0 if arch == "mnist" else -1.0
    assert float(got.min()) >= lo and float(got.max()) <= 1.0
    assert _max_dev(got, want) <= 1e-5


def _run_discriminator(arch, mode, dim, params, x, monkeypatch, keep_prob=0.5):
    draws = JaxDraws(monkeypatch, model=jax_dcgan)
    _, jax_disc = _jax_nets(arch, mode, dim)
    with apply_context(params):
        kw = {"keep_prob": keep_prob} if arch in _CHW else {}
        want = jax_disc(jnp.asarray(x), **kw)
    masks = draws.masks()
    _, port_disc = _port_nets(arch, mode, dim)
    p = from_jax_params({k: np.asarray(v) for k, v in params.items()})
    return lambda: port_disc(p, torch.from_numpy(x), InjectedRandomness(masks=masks), keep_prob), want, masks


@pytest.mark.parametrize("arch,mode,dim,batch", MODEL_CASES)
def test_discriminator_equals_jax(arch, mode, dim, batch, monkeypatch):
    """Full width, fp32, JAX's three masks (keep 0.5) injected: logits and
    the NHWC-flattened features."""
    c, h, w = _CHW[arch]
    x = np.random.default_rng(2).uniform(-1, 1, size=(batch, c * h * w)).astype(np.float32)
    run, want, masks = _run_discriminator(arch, mode, dim, _disc_params(arch, mode, dim, 2), x, monkeypatch)
    assert [m.shape[1:] for m, _ in masks] == [(h // 2, w // 2, dim), (-(-h // 4), -(-w // 4), 2 * dim),
                                              (4, 4, 4 * dim)]
    got = run()
    assert got[0].shape == (batch,) and got[1].shape == (batch, 16 * 4 * dim)
    for g, wt in zip(got, want):
        assert _max_dev(g, wt) <= 1e-5


@pytest.mark.parametrize("arch,mode,dim,batch", MODEL_CASES)
def test_models_bf16_equal_jax_and_fp32(arch, mode, dim, batch, monkeypatch):
    """G and D under the bf16 policy against JAX's bf16 and the fp32 port
    (bounds in the module's docstring)."""
    noise = np.random.default_rng(1).normal(size=(batch, 128)).astype(np.float32)
    c, h, w = _CHW[arch]
    x = np.random.default_rng(2).uniform(-1, 1, size=(batch, c * h * w)).astype(np.float32)
    gen = _gen_params(arch, mode, dim, 1)
    fp32_g, _ = _run_generator(arch, mode, dim, gen, noise)
    run_d, _, _ = _run_discriminator(arch, mode, dim, _disc_params(arch, mode, dim, 2), x, monkeypatch)
    fp32_d = run_d()
    default_tpu_policy(True)
    monkeypatch.undo()
    with precision_policy("bfloat16"):
        got_g, want_g = _run_generator(arch, mode, dim, gen, noise)
        run_d, want_d, _ = _run_discriminator(arch, mode, dim, _disc_params(arch, mode, dim, 2), x, monkeypatch)
        got_d = run_d()
    assert got_g.dtype == torch.bfloat16 and str(want_g.dtype) == "bfloat16"
    g_bound = 4 * U if (arch, mode) == ("mnist", "wgan-CT") else 8 * U
    assert _max_dev(got_g, want_g) <= g_bound
    assert _max_dev(got_g, fp32_g) <= 12 * U
    for g, wt, f in zip(got_d, want_d, fp32_d):
        assert g.dtype == torch.bfloat16 and str(wt.dtype) == "bfloat16"
        assert _max_dev(g, wt) <= 4 * U
        assert _max_dev(g, f) <= 12 * U


ARCH64_CASES = [("dcgan", "wgan-ct"), ("dcgan", "dcgan"), ("crippled", "wgan-gp"), ("fc", "wgan-ct"),
                ("multiplicative", "wgan-ct"), ("multiplicative", "lsgan")]


@pytest.mark.parametrize("arch,mode", ARCH64_CASES)
def test_64px_archs_equal_jax(arch, mode, monkeypatch):
    """The 64 px archs at dim 8, fp32: G on fixed noise (batch norm over 4,
    the even/odd gate) and D on G's samples (layer norm in wgan-ct, batch
    norm otherwise; no dropout)."""
    noise = np.random.default_rng(3).normal(size=(4, 128)).astype(np.float32)
    got_x, want_x = _run_generator(arch, mode, 8, _gen_params(arch, mode, 8, 4), noise)
    assert got_x.shape == (4, 64 * 64 * 3) and _max_dev(got_x, want_x) <= 1e-5
    run, want, masks = _run_discriminator(arch, mode, 8, _disc_params(arch, mode, 8, 4), np.asarray(want_x),
                                          monkeypatch)
    assert not masks
    got = run()
    assert got[1].shape == (4, 16 * 8 * 8)
    for g, w in zip(got, want):
        assert _max_dev(g, w) <= 1e-5


def test_input_slopes_equal_jax(monkeypatch):
    """``|dD(x)/dx|_2`` per example of the CIFAR D at dim 16 with JAX's
    masks, within 1e-5 of JAX's largest."""
    x = np.random.default_rng(6).uniform(-1, 1, size=(4, 3072)).astype(np.float32)
    params = _disc_params("cifar", "wgan-CT", 16, 6)
    draws = JaxDraws(monkeypatch, model=jax_dcgan)
    _, jax_disc = _jax_nets("cifar", "wgan-CT", 16)
    with apply_context(params):
        want = jax_losses.input_slopes(jax_disc, jnp.asarray(x))
    _, port_disc = _port_nets("cifar", "wgan-CT", 16)
    p = from_jax_params({k: np.asarray(v) for k, v in params.items()})
    rand = InjectedRandomness(masks=draws.masks())
    got = input_slopes(lambda v: port_disc(p, v, rand)[0], torch.from_numpy(x))
    assert rand.exhausted() and got.shape == (4,) and got.dtype == torch.float32
    assert _max_dev(got, want) <= 1e-5


# ---------------------------------------------------------------- MNIST data


def test_synthetic_mnist_equals_jax():
    from ctgan_tpu.data.synthetic import synthetic_mnist as jax_synthetic_mnist

    from ctgan_tpu_torch.data import synthetic_mnist

    for (gx, gy), (wx, wy) in zip(synthetic_mnist(50, 20, 10), jax_synthetic_mnist(50, 20, 10)):
        assert gx.dtype == np.float32 and gx.shape[1] == 784 and 0 <= gx.min() and gx.max() <= 1
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_mnist_file_and_batches_equal_jax(tmp_path, monkeypatch):
    """A ``mnist.pkl.gz`` is read as the JAX package reads it; the epoch
    batches of MNIST's and CIFAR-10's ``load`` are the JAX package's (the
    CIFAR-10 set cut small in both packages)."""
    from ctgan_tpu.data import cifar10 as jax_cifar10
    from ctgan_tpu.data import mnist as jax_mnist

    from ctgan_tpu_torch.data import cifar10, mnist
    from ctgan_tpu_torch.data.synthetic import synthetic_images

    small = lambda: (synthetic_images(64, 3, 32, seed=1), synthetic_images(16, 3, 32, seed=2))
    monkeypatch.setattr(jax_cifar10, "synthetic_cifar10", small)
    monkeypatch.setattr(cifar10, "_synthetic", small)

    rng = np.random.default_rng(0)
    splits = tuple((rng.uniform(size=(n, 784)).astype(np.float64), rng.integers(0, 10, n)) for n in (30, 12, 12))
    path = tmp_path / "mnist.pkl.gz"
    with gzip.open(path, "wb") as f:
        pickle.dump(splits, f)
    got, want = mnist.load_arrays(str(path), n_examples=20), jax_mnist.load_arrays(str(path), n_examples=20)
    assert got["train"][0].shape == (20, 784) and got["train"][0].dtype == np.float32
    for split in ("train", "dev", "test"):
        for g, w in zip(got[split], want[split]):
            np.testing.assert_array_equal(g, w)
    loaders = list(zip(mnist.load(4, 6, path=str(path)), jax_mnist.load(4, 6, path=str(path))))
    loaders += list(zip(cifar10.load(8, n_examples=40), jax_cifar10.load(8, n_examples=40)))
    for g_gen, w_gen in loaders:
        pairs = list(zip(g_gen(), w_gen()))
        assert len(pairs) >= 2
        for (gx, gy), (wx, wy) in pairs:
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
