"""The semi-supervised modules of ``ctgan_tpu_torch`` against ``ctgan_tpu``
on the CPU: the activations, Gaussian noise, the weight-normed layers and
their data-dependent init, parameter creation, both full-width classifiers
and generators, every loss, the Theano-style Adam, the crop-and-flip
augmentation, the SSL loader and label selection, and one trainer step of
each variant.

JAX's draws are injected (:class:`SslDraws`, after ``tests/torch_parity.py``):
the JAX functions draw Gaussian noise and dropout masks from a seeded NumPy
stream and latents from fixed keys, in call order, and record them; the port
gets the same values in the same order.  In JAX the latents and every
Gaussian-noise call share the ``"noise"`` stream
(``ctgan_tpu/models/classifiers.py:92``, ``ctgan_tpu/ops/noise.py:26``);
one queue in call order replays both.

Tolerances: layers, nets and losses 1e-5 of the reference's largest
magnitude (other summation orders; losses and the EMA 1e-6); parameters
bit for bit; ``AdamTheano`` 1e-6; augmentation, loader and selection
exactly; a trainer step's optimiser state 1e-4 of each tensor's scale, and
its parameters and averages the same plus the first Adam step's
amplification of the gradients' difference, ``lr / sqrt(eps)`` per unit of
gradient (the tiny CIFAR-10 net's NIN bias has gradients near 1e-4, where a
difference of 7e-6 of the gradient's scale moves the bias by 6.5e-4 of
its own).
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import ctgan_tpu.ops as jax_ops
from ctgan_tpu.apps.ct_mnist_ssl import select_labeled as jax_select_labeled
from ctgan_tpu.core import apply_context, init_context, rng_context, split_params
from ctgan_tpu.core import rng as jax_rng
from ctgan_tpu.data import augment as jax_augment
from ctgan_tpu.data import cifar10 as jax_cifar10
from ctgan_tpu.losses import semisup as jax_losses
from ctgan_tpu.models import classifiers as jc
from ctgan_tpu.ops import activations as jax_act
from ctgan_tpu.ops import weightnorm as jax_wn
from ctgan_tpu.train import SslConfig as JaxSslConfig
from ctgan_tpu.train import make_ssl_trainer as jax_make_ssl_trainer
from ctgan_tpu.train import optim as jax_optim

from ctgan_tpu_torch import ops as port_ops
from ctgan_tpu_torch.apps.ssl_common import select_labeled
from ctgan_tpu_torch.bridge import from_jax_params, to_jax_params
from ctgan_tpu_torch.data import augment as port_augment
from ctgan_tpu_torch.data import cifar10 as port_cifar10
from ctgan_tpu_torch.losses import semisup as port_losses
from ctgan_tpu_torch.models import classifiers as pc
from ctgan_tpu_torch.train import SslConfig, data_dependent_init, make_ssl_trainer
from ctgan_tpu_torch.train.optim import AdamTheano

import torch_parity  # noqa: F401  (one intra-op thread per worker)
import torch_tiny_ssl
from torch_parity import nhwc_to_nchw


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _max_dev(got, want) -> float:
    """Largest deviation over the largest magnitude of ``want``."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    scale = np.max(np.abs(want))
    return float(np.max(np.abs(got - want)) / scale) if scale else float(np.max(np.abs(got)))


class SslDraws:
    """Patches the JAX classifiers so that Gaussian noise and dropout masks
    come from ``default_rng(seed)`` and latents from fixed keys, recorded in
    call order; :meth:`injected` hands the port the same draws."""

    def __init__(self, monkeypatch, seed: int = 0):
        self._np = np.random.default_rng(seed)
        self._keys = list(jax.random.split(jax.random.PRNGKey(seed), 64))
        self.draws: list[tuple] = []
        monkeypatch.setattr(jc, "gaussian_noise", self._noise)
        monkeypatch.setattr(jc, "dropout", self._dropout)
        monkeypatch.setattr(jax_ops, "dropout", self._dropout)  # the tiny nets import it when patched in
        monkeypatch.setattr(jax_rng, "next_key", self._next_key)

    def _noise(self, x, sigma=0.1, *, deterministic=False, stream="noise"):
        if deterministic or sigma == 0:
            return x
        z = self._np.normal(size=x.shape).astype(np.float32)
        self.draws.append(("normal", z))
        return x + sigma * jnp.asarray(z)

    def _dropout(self, x, keep_prob, *, deterministic=False, **kw):
        if deterministic or keep_prob >= 1.0:
            return x
        keep = self._np.uniform(size=x.shape) < keep_prob
        self.draws.append(("mask", keep, keep_prob))
        scale = (1.0 / jnp.asarray(keep_prob, jnp.float32)).astype(x.dtype)
        return jnp.where(jnp.asarray(keep), x * scale, jnp.zeros((), x.dtype))

    def _next_key(self, stream="default"):
        assert stream == "noise", stream
        key = self._keys.pop(0)
        self.draws.append(("uniform", key))
        return key

    def injected(self) -> "InjectedSsl":
        return InjectedSsl(list(self.draws))


class InjectedSsl:
    """The port's randomness provider, replaying :class:`SslDraws`' record
    and checking each request against it."""

    def __init__(self, draws):
        self._draws = draws

    def exhausted(self) -> bool:
        return not self._draws

    def _pop(self, kind):
        draw = self._draws.pop(0)
        assert draw[0] == kind, (draw[0], kind)
        return draw[1:]

    def normal(self, shape):
        (z,) = self._pop("normal")
        assert z.shape == tuple(shape), (z.shape, shape)
        return torch.from_numpy(z)

    def uniform(self, n, dim):
        (key,) = self._pop("uniform")
        return torch.from_numpy(np.array(jax.random.uniform(key, (n, dim))))

    def dropout_mask(self, shape, keep_prob, dtype, device):
        keep, kp = self._pop("mask")
        assert kp == keep_prob
        keep = nhwc_to_nchw(keep) if keep.ndim == 4 else keep
        assert keep.shape == tuple(shape), (keep.shape, shape)
        return torch.from_numpy(np.where(keep, np.float32(1.0 / kp), np.float32(0.0))).to(dtype)


# ---------------------------------------------------------------- activations, noise


def test_softplus_and_log_sum_exp_equal_jax():
    x = np.random.default_rng(0).normal(0.0, 30.0, (16, 10)).astype(np.float32)
    x[0, :2] = 5.0  # a tie at the maximum
    assert _max_dev(port_ops.softplus(torch.from_numpy(x)), jax_act.softplus(jnp.asarray(x))) < 1e-6
    assert _max_dev(port_ops.log_sum_exp(torch.from_numpy(x)), jax_act.log_sum_exp(jnp.asarray(x))) < 1e-6
    t = torch.from_numpy(x).requires_grad_(True)
    port_ops.log_sum_exp(t).sum().backward()
    want = jax.grad(lambda a: jax_act.log_sum_exp(a).sum())(jnp.asarray(x))
    assert _max_dev(t.grad, want) < 1e-6


def test_gaussian_noise_adds_sigma_times_the_draw():
    x = torch.ones(3, 4)
    draws = InjectedSsl([("normal", np.full((3, 4), 2.0, np.float32))])
    assert torch.equal(port_ops.gaussian_noise(x, 0.5, draws), torch.full((3, 4), 2.0))
    assert port_ops.gaussian_noise(x, 0.5, None, deterministic=True) is x
    assert port_ops.gaussian_noise(x, 0.0, None) is x


# ---------------------------------------------------------------- weight-normed layers


def _jax_layer(fn, x, **kw):
    """The JAX layer's params, its output and its data-dependent init's
    outputs and updates."""
    with init_context(seed=3) as ctx:
        fn(jnp.asarray(x), **kw)
    params = dict(ctx.params)
    with apply_context(params):
        out = fn(jnp.asarray(x), **kw)
    with apply_context(params) as ictx:
        init_out = fn(jnp.asarray(x), dd_init=True, **kw)
        updates = dict(ictx.init_updates)
    return {k: np.asarray(v) for k, v in params.items()}, out, init_out, updates


LAYER_CASES = {
    "dense": (lambda x, **kw: jax_wn.wn_dense("L", 12, 7, x, **kw), (5, 12), {}),
    "dense_linear_out": (lambda x, **kw: jax_wn.wn_dense("L", 12, 7, x, nonlinearity=None, init_stdv=0.1, **kw),
                         (5, 12), {"nonlinearity": None, "init_stdv": 0.1}),
    "conv_pad1_stride2": (lambda x, **kw: jax_wn.wn_conv2d("L", 3, 6, 3, x, pad=1, stride=2,
                                                           nonlinearity=jax_act.leaky_relu, **kw),
                          (2, 8, 8, 3), {"pad": 1, "stride": 2, "nonlinearity": port_ops.leaky_relu}),
    "conv_valid": (lambda x, **kw: jax_wn.wn_conv2d("L", 3, 6, 3, x, pad="VALID", **kw), (2, 6, 6, 3),
                   {"pad": "VALID"}),
    "conv_nin_same": (lambda x, **kw: jax_wn.wn_conv2d("L", 3, 6, 1, x, **kw), (2, 4, 4, 3), {}),
    "deconv": (lambda x, **kw: jax_wn.wn_deconv2d("L", 4, 3, 5, x, nonlinearity=jnp.tanh, init_stdv=0.1, **kw),
               (2, 4, 4, 4), {"nonlinearity": torch.tanh, "init_stdv": 0.1}),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_weightnormed_layer_and_its_init_equal_jax(case):
    """Forward to 1e-5, and the data-dependent init's output and new g, b."""
    fn, shape, kw = LAYER_CASES[case]
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    params, out, init_out, updates = _jax_layer(fn, x)
    p = from_jax_params(params)
    op = {"dense": port_ops.wn_dense, "conv": port_ops.wn_conv2d, "deconv": port_ops.wn_deconv2d}[case.split("_")[0]]
    xin = torch.from_numpy(nhwc_to_nchw(x) if x.ndim == 4 else x)
    w = port_ops.applied_weight(p["L.W"], p["L.g"], 1 if case == "deconv" else 0)
    got = op(xin, w, p["L.g"], p["L.b"], **kw)
    to_ref = (lambda t: nhwc_to_nchw(np.asarray(t))) if x.ndim == 4 else np.asarray
    assert _max_dev(got, to_ref(out)) < 1e-5
    recorded = {}
    got_init = op(xin, w, p["L.g"], p["L.b"], on_init=lambda g, b: recorded.update(g=g, b=b), **kw)
    assert _max_dev(got_init, to_ref(init_out)) < 1e-5
    assert _max_dev(recorded["g"], updates["L.g"]) < 1e-5 and _max_dev(recorded["b"], updates["L.b"]) < 1e-5


def test_l2_dense_equals_jax():
    x = np.random.default_rng(2).normal(size=(4, 9)).astype(np.float32)
    fn = lambda a, **kw: jax_wn.l2_dense("L", 9, 5, a, nonlinearity=jax.nn.sigmoid)  # noqa: E731
    with init_context(seed=3) as ctx:
        fn(jnp.asarray(x))
    with apply_context(ctx.params):
        want = fn(jnp.asarray(x))
    p = from_jax_params({k: np.asarray(v) for k, v in ctx.params.items()})
    assert _max_dev(port_ops.l2_dense(torch.from_numpy(x), p["L.W"], nonlinearity=torch.sigmoid), want) < 1e-5


def test_data_dependent_init_merges_and_refuses_unknown_params():
    params = {"L.g": torch.ones(2), "L.b": torch.zeros(2), "other": torch.ones(1)}
    out = data_dependent_init(params, lambda u: u.update({"L.g": torch.full((2,), 3.0), "L.b": torch.ones(2)}))
    assert torch.equal(out["L.g"], torch.full((2,), 3.0)) and out["other"] is params["other"]
    assert torch.equal(params["L.g"], torch.ones(2))  # a new dict
    with pytest.raises(KeyError, match="unknown param"):
        data_dependent_init(params, lambda u: u.update({"M.g": torch.ones(2)}))


# ---------------------------------------------------------------- models


@pytest.fixture(scope="module")
def jax_params():
    """Each arch's params as the JAX app creates them (seed 2)."""
    out = {}
    for arch in ("mnist", "cifar"):
        with init_context(seed=2) as ctx:
            with rng_context(jax.random.PRNGKey(2)):
                if arch == "mnist":
                    jc.mnist_ssl_classifier(jnp.zeros((2, 784)))
                    jc.mnist_ssl_generator(2)
                else:
                    jc.cifar_ssl_classifier(jnp.zeros((2, 32, 32, 3)))
                    jc.cifar_ssl_generator(2)
        out[arch] = {k: np.asarray(v) for k, v in ctx.params.items()}
    return out


@pytest.mark.parametrize("arch", ["mnist", "cifar"])
def test_init_params_equal_jax(jax_params, arch):
    want = jax_params[arch]
    got = pc.init_params(arch, 2)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("arch", ["mnist", "cifar"])
def test_classifier_and_generator_equal_jax(jax_params, arch, monkeypatch):
    """Full width: a stochastic pass (JAX's noise or masks injected) and a
    deterministic one, logits and both feature outputs; G on given latents,
    and on drawn ones (the injected uniform)."""
    n = 3 if arch == "mnist" else 2
    rng = np.random.default_rng(5)
    x = (rng.uniform(size=(n, 784)) if arch == "mnist" else rng.uniform(-0.5, 0.5, (n, 3072))).astype(np.float32)
    params = {k: jnp.asarray(v) for k, v in jax_params[arch].items()}
    p = from_jax_params(jax_params[arch])
    jax_cls, port_cls = ((jc.mnist_ssl_classifier, pc.mnist_ssl_classifier) if arch == "mnist"
                         else (jc.cifar_ssl_classifier, pc.cifar_ssl_classifier))
    jax_gen, port_gen = ((jc.mnist_ssl_generator, pc.mnist_ssl_generator) if arch == "mnist"
                         else (jc.cifar_ssl_generator, pc.cifar_ssl_generator))
    draws = SslDraws(monkeypatch)
    with apply_context(params):
        want = [jax_cls(jnp.asarray(x)), jax_cls(jnp.asarray(x), deterministic=True), jax_gen(n)]
    rand = draws.injected()
    with torch.no_grad():
        pw = pc.with_applied_weights(p)
        got = [port_cls(pw, torch.from_numpy(x), rand), port_cls(pw, torch.from_numpy(x), None, deterministic=True),
               port_gen(p, n, rand)]
    assert rand.exhausted()
    for g, w in zip(got[:2], want[:2]):
        for a, b in zip(g, w):
            assert _max_dev(a, b) < 1e-5
    assert _max_dev(got[2], want[2]) < 1e-5
    z = rng.uniform(size=(n, 100 if arch == "mnist" else 50)).astype(np.float32)
    with apply_context(params):
        want_g = jax_gen(n, noise=jnp.asarray(z))
    with torch.no_grad():
        assert _max_dev(port_gen(p, n, None, noise=torch.from_numpy(z)), want_g) < 1e-5


@pytest.mark.parametrize("arch", ["mnist", "cifar"])
def test_data_dependent_init_of_the_classifier_equals_jax(jax_params, arch, monkeypatch):
    """The app's init pass (noise or masks injected) at batch 8: every new
    g and b."""
    from ctgan_tpu.train import data_dependent_init as jax_ddi

    rng = np.random.default_rng(6)
    x = (rng.uniform(size=(8, 784)) if arch == "mnist" else rng.uniform(-0.5, 0.5, (8, 3, 32, 32))).astype(np.float32)
    draws = SslDraws(monkeypatch)
    jax_cls = jc.mnist_ssl_classifier if arch == "mnist" else jc.cifar_ssl_classifier
    x_jax = x if arch == "mnist" else np.transpose(x, (0, 2, 3, 1))
    want = jax_ddi({k: jnp.asarray(v) for k, v in jax_params[arch].items()},
                   lambda: jax_cls(jnp.asarray(x_jax), dd_init=True), jax.random.PRNGKey(2))
    rand = draws.injected()
    port_cls = pc.mnist_ssl_classifier if arch == "mnist" else pc.cifar_ssl_classifier
    p = from_jax_params(jax_params[arch])
    got = data_dependent_init(p, lambda u: port_cls(pc.with_applied_weights(p), torch.from_numpy(x), rand,
                                                    init_updates=u))
    assert rand.exhausted()
    changed = [k for k in want if not np.array_equal(np.asarray(want[k]), jax_params[arch][k])]
    assert changed and all(k.endswith((".g", ".b")) for k in changed)
    for k in changed:
        assert _max_dev(got[k], want[k]) < 1e-5, k


# ---------------------------------------------------------------- losses


def _loss_inputs(seed=0, n=6):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0.0, 3.0, s).astype(np.float32)  # noqa: E731
    return {"logits_unl": f(n, 10), "logits_unl2": f(n, 10), "feat_unl": f(n, 16), "feat_unl2": f(n, 16),
            "logits_fake": f(n, 10), "labels": rng.integers(0, 10, n),
            "targets": (np.asarray(jax.nn.softmax(f(n, 10))), f(n, 16))}


LOSS_CASES = {
    "labeled": lambda m, a: m.labeled_loss(a["logits_unl"], a["labels"]),
    "error": lambda m, a: m.classification_error(a["logits_unl"], a["labels"]),
    "mnist": lambda m, a: m.ct_mnist_unlabeled_loss(a["logits_unl"], a["logits_unl2"], a["feat_unl"], a["feat_unl2"],
                                                    a["logits_fake"], lambda_2=0.1, factor_m=0.0),
    "mnist_hinge": lambda m, a: m.ct_mnist_unlabeled_loss(a["logits_unl"], a["logits_unl2"], a["feat_unl"],
                                                          a["feat_unl2"], a["logits_fake"], lambda_2=2.0,
                                                          factor_m=0.05, feature_weight=0.1),
    "cifar": lambda m, a: m.ct_cifar_unlabeled_loss(a["logits_unl"], a["logits_unl2"], a["feat_unl"], a["feat_unl2"],
                                                    a["logits_fake"]),
    "te": lambda m, a: m.ct_te_unlabeled_loss(a["logits_unl"], a["feat_unl"], *a["targets"], a["logits_fake"],
                                              lambda_2=1.0, factor_m=0.02),
    "fm_sq": lambda m, a: m.feature_matching_sq(a["feat_unl"], a["feat_unl2"]),
    "fm_abs": lambda m, a: m.feature_matching_abs(a["feat_unl"], a["feat_unl2"]),
}


def _as(lib, a):
    conv = (lambda v: torch.from_numpy(np.asarray(v))) if lib == "torch" else jnp.asarray
    return {k: tuple(conv(t) for t in v) if isinstance(v, tuple) else conv(v) for k, v in a.items()}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_losses_equal_jax(case):
    a = _loss_inputs()
    got, want = LOSS_CASES[case](port_losses, _as("torch", a)), LOSS_CASES[case](jax_losses, _as("jax", a))
    for g, w in zip(*(v if isinstance(v, tuple) else (v,) for v in (got, want))):
        assert abs(float(g) - float(w)) <= 1e-6 * max(1.0, abs(float(w))), (case, float(g), float(w))


@pytest.mark.parametrize("epoch_index", [0, 1, 7])
def test_ema_targets_update_equals_jax(epoch_index):
    rng = np.random.default_rng(epoch_index)
    ens, preds = rng.normal(size=(2, 50, 10)).astype(np.float32)
    got = port_losses.ema_targets_update(torch.from_numpy(ens), torch.from_numpy(preds), epoch_index, decay=0.6)
    want = jax_losses.ema_targets_update(jnp.asarray(ens), jnp.asarray(preds), epoch_index, decay=0.6)
    for g, w in zip(got, want):
        assert _max_dev(g, w) < 1e-6


# ---------------------------------------------------------------- optimiser


def test_adam_theano_three_steps_equal_jax():
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32), "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(0.0, s, v.shape).astype(np.float32) for k, v in params.items()} for s in (1.0, 1e-3, 1e-5)]
    jopt = jax_optim.adam_theano(3e-3, 0.5)
    jp, js = {k: jnp.asarray(v) for k, v in params.items()}, None
    js = jopt.init(jp)
    opt = AdamTheano(3e-3, 0.5)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    for step, g in enumerate(grads):
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, step)
        opt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, step)
    for k in params:
        assert _max_dev(tp[k], jp[k]) < 1e-6
        assert _max_dev(ts["m"][k], js["m"][k]) < 1e-6 and _max_dev(ts["v"][k], js["v"][k]) < 1e-6
    assert ts["t"] == float(js["t"]) == 4.0


# ---------------------------------------------------------------- data


def test_random_crop_flip_equals_jax_exactly():
    """JAX's offsets and flips of a key, injected: the same pixels."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.5, 0.5, (6, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax_augment.random_crop_flip(jnp.asarray(x), key))
    kf, ky, kx = jax.random.split(key, 3)
    oy, ox = (np.asarray(jax.random.randint(k, (6,), 0, 5)) for k in (ky, kx))
    flip = np.asarray(jax.random.bernoulli(kf, 0.5, (6,)))
    assert 0 < flip.sum() < 6
    got = port_augment.random_crop_flip(torch.from_numpy(nhwc_to_nchw(x)), torch.from_numpy(np.stack([oy, ox], 1)),
                                        torch.from_numpy(flip))
    assert np.array_equal(got.numpy(), nhwc_to_nchw(want))


def test_two_stream_augment_draws_two_independent_copies():
    from ctgan_tpu_torch.core import Randomness

    x = torch.rand(8, 3, 32, 32)
    a, b = port_augment.two_stream_augment(x, Randomness(0, "cpu"))
    a2, _ = port_augment.two_stream_augment(x, Randomness(0, "cpu"))
    assert a.shape == b.shape == x.shape and torch.equal(a, a2) and not torch.equal(a, b)


def _write_batches(root, rng):
    """Five tiny python-format CIFAR-10 training batches and a test batch."""
    for name, n in [(f"data_batch_{i}", 12) for i in range(1, 6)] + [("test_batch", 10)]:
        with open(root / name, "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         "labels": list(rng.integers(0, 10, n))}, f)


def test_load_normalized_equals_jax_exactly(tmp_path):
    _write_batches(tmp_path, np.random.default_rng(0))
    for subset in ("train", "test"):
        got = port_cifar10.load_normalized(str(tmp_path), subset)
        want = jax_cifar10.load_normalized(str(tmp_path), subset)
        assert got[0].dtype == want[0].dtype == np.float32 and got[0].shape[1:] == (3, 32, 32)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert got[0].min() >= -0.5 and got[0].max() <= 0.5


def test_label_selection_equals_jax_exactly():
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(500, 7)).astype(np.float32), rng.integers(0, 10, 500)
    got = select_labeled(x, y, 10, np.random.default_rng(2))
    want = jax_select_labeled(x, y, 10, np.random.default_rng(2))
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert np.array_equal(np.bincount(got[1]), np.full(10, 10))


# ---------------------------------------------------------------- one trainer step


def _tiny_jax_params(arch: str):
    """The JAX params of the trainer-step test's nets (seed 0): MNIST's real
    nets, or tiny_ssl.py's CIFAR-10 nets (patched in by the caller)."""
    with init_context(seed=0) as ctx:
        with rng_context(jax.random.PRNGKey(0)):
            if arch == "mnist":
                jc.mnist_ssl_classifier(jnp.zeros((2, 784)))
                jc.mnist_ssl_generator(2)
            else:
                jc.cifar_ssl_classifier(jnp.zeros((2, 32, 32, 3)))
                jc.cifar_ssl_generator(2)
    return {k: np.asarray(v) for k, v in ctx.params.items()}


@pytest.mark.parametrize("variant", ["mnist", "cifar", "te"])
def test_trainer_step_equals_jax(variant, monkeypatch):
    """One step of JAX's ``step_fn`` (eager, draws injected) and of the
    port's ``SslTrainer.step``: D's and G's params, the average, both
    optimisers' moments and t, the step; and the metrics and the
    unlabelled pass's softmax and features.  MNIST at full width and batch
    8, CIFAR-10 with tiny_ssl.py's nets at batch 4."""
    from tiny_ssl import apply_tiny_ssl_models

    draws = SslDraws(monkeypatch)
    arch = "mnist" if variant == "mnist" else "cifar"
    if arch == "cifar":
        apply_tiny_ssl_models(setter=monkeypatch.setattr)
        torch_tiny_ssl.apply_tiny_ssl_models(monkeypatch.setattr)
    params = _tiny_jax_params(arch)
    assert params.keys() == pc.init_params(arch, 0).keys()
    assert all(np.array_equal(params[k], v) for k, v in pc.init_params(arch, 0).items())
    draws.draws.clear()
    n = 8 if arch == "mnist" else 4
    rng = np.random.default_rng(3)
    shape = (784,) if arch == "mnist" else (32, 32, 3)
    x = lambda: rng.uniform(-0.5, 0.5, (n, *shape)).astype(np.float32)  # noqa: E731
    x_lab, labels, x_unl, x_unl2 = x(), rng.integers(0, 10, n), x(), x()
    targets = None
    if variant == "te":
        targets = (np.asarray(jax.nn.softmax(rng.normal(size=(n, 10)).astype(np.float32))),
                   rng.normal(0.0, 0.1, (n, 128)).astype(np.float32))
    lr, lam = (3e-3, 0.1) if arch == "mnist" else (3e-4, 1.0)
    cls_name, gen_name = (("mnist_ssl_classifier", "mnist_ssl_generator") if arch == "mnist"
                          else ("cifar_ssl_classifier", "cifar_ssl_generator"))

    init_state, step_fn, _, _ = jax_make_ssl_trainer(getattr(jc, cls_name), getattr(jc, gen_name),
                                                     JaxSslConfig(variant=variant, lr=lr, lambda_2=lam))
    disc, gen, _ = split_params({k: jnp.asarray(v) for k, v in params.items()}, "Classifier", "Generator")
    jstate, (jmetrics, jprobs, jfeats) = step_fn(
        init_state(disc, gen), jnp.asarray(x_lab), jnp.asarray(labels), jnp.asarray(x_unl), jnp.asarray(x_unl2),
        None if targets is None else tuple(map(jnp.asarray, targets)), jax.random.PRNGKey(0))

    rand = draws.injected()
    trainer = make_ssl_trainer(getattr(pc, cls_name), getattr(pc, gen_name),
                               SslConfig(variant=variant, lr=lr, lambda_2=lam))
    pd, pg, _ = split_params(from_jax_params(params), "Classifier", "Generator")
    state = trainer.init_state(pd, pg)
    t = lambda a: torch.from_numpy(nhwc_to_nchw(a) if a.ndim == 4 else a)  # noqa: E731
    metrics, probs, feats = trainer.step(state, t(x_lab), torch.from_numpy(labels), t(x_unl), t(x_unl2),
                                         None if targets is None else tuple(map(torch.from_numpy, targets)), rand)
    assert rand.exhausted()
    assert state.step == int(jstate.step) == 1
    for k, v in jmetrics.items():
        assert abs(float(metrics[k]) - float(v)) <= 1e-5 * max(1.0, abs(float(v))), (k, float(metrics[k]), float(v))
    assert _max_dev(probs, jprobs) < 1e-5 and _max_dev(feats, jfeats) < 1e-5

    def close(got: dict, want: dict, what: str, amplified: dict | None = None):
        """Each tensor within 1e-4 of its scale, plus, for the params, what
        the Adam step makes of the gradients' own difference."""
        got = to_jax_params(got)
        assert got.keys() == want.keys(), what
        for k, w in want.items():
            w = np.asarray(w, np.float64)
            allowed = 1e-4 * max(float(np.max(np.abs(w))), 1e-30) + (0.0 if amplified is None else amplified[k])
            assert np.all(np.abs(got[k] - w) <= allowed), f"{what} {k}: {float(np.max(np.abs(got[k] - w))):.3g}"

    for field in ("disc_opt", "gen_opt"):
        for moment in ("m", "v"):
            close(getattr(state, field)[moment], getattr(jstate, field)[moment], f"{field} {moment}")
        assert getattr(state, field)["t"] == float(getattr(jstate, field)["t"]) == 2.0
    # AdamTheano's first step moves p by lr * g / sqrt(g^2 + eps), whose slope
    # in g reaches lr / sqrt(eps) at g = 0: where a gradient lies near 1e-4,
    # the gradients' difference, held above through m = (1 - mom1) g, comes
    # back amplified up to 1e4-fold.
    slope = lr / np.sqrt(1e-8) / (1 - trainer.cfg.mom1)
    for field, opt, rate in (("disc_params", "disc_opt", 1.0), ("gen_params", "gen_opt", 1.0),
                             ("avg_params", "disc_opt", trainer.cfg.ema_rate)):
        dm = {k: rate * slope * np.abs(v - np.asarray(getattr(jstate, opt)["m"][k], np.float64))
              for k, v in to_jax_params(getattr(state, opt)["m"]).items()}
        close(getattr(state, field), getattr(jstate, field), field, dm)
