"""The bf16 precision policy of ``ctgan_tpu_torch`` against the JAX
package's on the CPU (``default_tpu_policy(True)`` on the JAX side, as
``tests/test_bf16_policy.py`` runs it).  dim 16, batch 4; every draw is
injected from the JAX side (tests/torch_parity.py).

Tolerances are multiples of bf16's unit roundoff ``U = 2**-8``, scaled by
the largest magnitude of the reference:

* port against JAX, both in bf16: the two round at the same points and
  differ only in the order of fp32 sums, so a rounding can land one way or
  the other: ``4 U``.
* bf16 port against fp32 port: G passes through about a dozen bf16
  roundings (linear, three blocks of norm, conv and shortcut, the output
  conv, ``tanh``), D through about as many: ``12 U`` (4.7e-2), under the
  5e-2 cap.
* a substep's losses: ``4 U`` relative, against JAX and against fp32 (the
  losses are means over G and D outputs that carry those roundings; the
  WGAN difference, a difference of two such means, ``4 U`` absolute).
* parameters after a substep: Adam moves an element by at most about
  ``lr`` per update, so two runs differ by at most ``2 lr``.  In bf16 a
  gradient element smaller than its rounding error can change sign, and
  its parameter then steps the other way; those elements are small, and
  together they may carry at most ``4 U`` of the gradient's L1 mass (the
  fp32 port's gradient, which TF-Adam's first moment holds at beta1 = 0).
  (Counted by element, 2-5% of them step the other way in this test;
  their mass is 0.1-0.7%.)

``precision_policy`` is process-wide state; the fixture restores fp32 after
every test (xdist runs a file's tests in one process).
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ctgan_tpu import ops as jax_ops
from ctgan_tpu.core import apply_context, default_tpu_policy, init_context, rng_context
from ctgan_tpu.losses import gan as jax_losses
from ctgan_tpu.models import resnet_cifar as jax_resnet
from ctgan_tpu.ops.dropout import dropout as jax_dropout
from ctgan_tpu.train import AcganConfig as JaxAcganConfig
from ctgan_tpu.train import make_acgan_trainer

from ctgan_tpu_torch import ops as port_ops
from ctgan_tpu_torch.bridge import from_jax_params, to_jax_params
from ctgan_tpu_torch.core import compute_dtype, default_policy, precision_policy
from ctgan_tpu_torch.losses import gan as port_losses
from ctgan_tpu_torch.models import resnet_cifar as port_resnet
from ctgan_tpu_torch.train import AcganConfig, AcganState, AcganTrainer

from torch_parity import (
    KP,
    InjectedRandomness,
    JaxDraws,
    dequant_draws,
    jax_init_params,
    jax_model_cfg,
    nhwc_to_nchw,
    port_model_cfg,
    to_port,
)

DIM, BATCH, N_CRITIC, LR = 16, 4, 2, 2e-4
U = 2.0 ** -8


@pytest.fixture(autouse=True)
def _fp32_after():
    yield
    default_policy(False)
    default_tpu_policy(False)


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _max_dev(got, want) -> float:
    """Largest deviation over the largest magnitude of ``want``."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ------------------------------------------------------------ the policy


def test_precision_policy_float32_restores_fp32():
    x, w = torch.ones(2, 4), torch.ones(3, 4)
    default_policy(True)
    assert port_ops.linear(x, w).dtype == torch.bfloat16
    with precision_policy("float32"):
        assert compute_dtype() == torch.float32
        assert port_ops.linear(x, w).dtype == torch.float32
        with precision_policy(torch.bfloat16):
            assert port_ops.linear(x, w).dtype == torch.bfloat16
        assert port_ops.linear(x, w, torch.zeros(3)).dtype == torch.float32
    assert compute_dtype() == torch.bfloat16
    seen = []
    with precision_policy("float32"):  # the stack is per thread, the default per process
        thread = threading.Thread(target=lambda: seen.append(compute_dtype()))
        thread.start()
        thread.join()
    assert seen == [torch.bfloat16]
    default_policy(False)
    assert compute_dtype() == torch.float32
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        with precision_policy("float16"):
            pass


def test_cpu_bf16_conv_double_backward_accumulates_in_fp32():
    """The GP differentiates D's input gradient once more.  On a CPU tensor
    ``core.matmul.conv`` rounds its operands to bf16 and accumulates in
    fp32, as the card does: the filter's second-order gradient is within
    ``U`` (relative, normwise) of float64's.  PyTorch's own bf16 CPU
    convolution accumulates this one in bf16 and was 101% off here (torch
    2.13.0+cpu), which is why the CPU path does not use it."""
    from ctgan_tpu_torch.core.matmul import conv

    gen = torch.Generator().manual_seed(0)
    x, go = torch.randn(4, 3, 32, 32, generator=gen), torch.randn(4, 16, 32, 32, generator=gen)
    w = 0.2 * torch.randn(16, 3, 3, 3, generator=gen)

    def second_order(fn, dtype):
        xx, ww = x.to(dtype).requires_grad_(True), w.to(dtype).requires_grad_(True)
        y = fn(xx, ww)
        (g,) = torch.autograd.grad(y, xx, go.to(y.dtype), create_graph=True)
        (h,) = torch.autograd.grad(g.double().square().sum(), ww)
        return h.double()

    want = second_order(lambda a, b: torch.nn.functional.conv2d(a, b, padding=1), torch.float64)
    with precision_policy("bfloat16"):
        got = second_order(lambda a, b: conv(a, b, padding=1), torch.float32)
    assert float((got - want).norm() / want.norm()) <= U


# ------------------------------------------------- dtype flow, op by op


def _jax_op(name, x, labels):
    if name == "conv2d":
        return jax_ops.conv2d("C", x.shape[-1], 4, 3, x)
    if name == "conv_mean_pool2d":
        return jax_ops.conv_mean_pool2d("C", x.shape[-1], 4, 3, x)
    if name == "mean_pool_conv2d":
        return jax_ops.mean_pool_conv2d("C", x.shape[-1], 4, 1, x)
    if name == "linear":
        return jax_ops.linear("L", x.shape[-1], 4, x)
    if name == "batchnorm":
        return jax_ops.batchnorm("N", x)
    if name == "cond_batchnorm":
        return jax_ops.cond_batchnorm("N", x, labels, 10)
    if name == "layernorm":
        return jax_ops.layernorm("N", x)
    if name == "cond_layernorm":
        return jax_ops.cond_layernorm("N", x, labels, 10)
    if name == "dropout":
        return jax_dropout(x, 0.5, key=jax.random.PRNGKey(1))
    if name == "mean_pool":
        return jax_ops.mean_pool(x)
    if name == "upsample_nearest":
        return jax_ops.upsample_nearest(x)
    raise AssertionError(name)


def _port_op(name, x, labels):
    c = x.shape[1] if x.ndim == 4 else x.shape[-1]
    if name == "conv2d":
        return port_ops.conv2d(x, torch.ones(4, c, 3, 3), torch.zeros(4))
    if name == "conv_mean_pool2d":
        return port_ops.conv_mean_pool2d(x, torch.ones(4, c, 3, 3), torch.zeros(4))
    if name == "mean_pool_conv2d":
        return port_ops.mean_pool_conv2d(x, torch.ones(4, c, 1, 1), torch.zeros(4))
    if name == "linear":
        return port_ops.linear(x, torch.ones(4, c), torch.zeros(4))
    if name == "batchnorm":
        return port_ops.batchnorm(x, torch.ones(c), torch.zeros(c))
    if name == "cond_batchnorm":
        return port_ops.cond_batchnorm(x, labels, torch.ones(10, c), torch.zeros(10, c))
    if name == "layernorm":
        return port_ops.layernorm(x, torch.ones(c), torch.zeros(c))
    if name == "cond_layernorm":
        return port_ops.cond_layernorm(x, labels, torch.ones(10, c), torch.zeros(10, c))
    if name == "dropout":
        return port_ops.dropout(x, 0.5, InjectedRandomness(masks=[(np.ones((2, 8, 8, 3), bool), 0.5)]))
    if name == "mean_pool":
        return port_ops.mean_pool(x)
    if name == "upsample_nearest":
        return port_ops.upsample_nearest(x)
    raise AssertionError(name)


OPS = ["conv2d", "conv_mean_pool2d", "mean_pool_conv2d", "linear", "batchnorm", "cond_batchnorm",
       "layernorm", "cond_layernorm", "dropout", "mean_pool", "upsample_nearest"]
# JAX's fp32 conv refuses a bf16 input (lax.conv_general_dilated wants one
# dtype); the flagship never gives it one, so those three cases are left out
DTYPE_CASES = [
    (op, in_dtype, policy)
    for op in OPS for in_dtype in ("float32", "bfloat16") for policy in ("bf16_policy", "fp32_policy")
    if not ("conv" in op and in_dtype == "bfloat16" and policy == "fp32_policy")
]


@pytest.mark.parametrize("op,in_dtype,policy", DTYPE_CASES)
def test_op_dtype_flow_equals_jax(op, in_dtype, policy):
    """The output dtype of every op of the flagship, for an fp32 or a bf16
    activation under either policy, is the JAX op's: exact."""
    bf16_policy = policy == "bf16_policy"
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8, 3) if op != "linear" else (2, 3)).astype(np.float32)
    labels = np.array([1, 7])
    default_tpu_policy(bf16_policy)
    with init_context(seed=0), rng_context(jax.random.PRNGKey(0)):
        want = _jax_op(op, jnp.asarray(x).astype(in_dtype), jnp.asarray(labels))
    default_policy(bf16_policy)
    xt = torch.from_numpy(nhwc_to_nchw(x) if x.ndim == 4 else x).to(getattr(torch, in_dtype))
    got = _port_op(op, xt, torch.from_numpy(labels))
    assert _dtype_name(got) == str(want.dtype), (op, in_dtype)


def test_loss_dtypes_equal_jax():
    """bf16 critic scores, features and logits: every loss comes out fp32,
    as in JAX; the GP's input gradient is fp32 (its input is)."""
    rng = np.random.default_rng(1)
    d = [rng.normal(size=s).astype(np.float32) for s in ((4,), (4,), (4, 16), (4, 16), (4, 10))]
    labels = np.array([0, 3, 9, 2])
    j = [jnp.asarray(v, jnp.bfloat16) for v in d]
    p = [torch.from_numpy(v).to(torch.bfloat16) for v in d]
    pairs = [
        (jax_losses.wgan_losses(j[0], j[1])[1], port_losses.wgan_losses(p[0], p[1])[1]),
        (jax_losses.consistency_term(*j[:4]), port_losses.consistency_term(*p[:4])),
        (jax_losses.acgan_loss(j[4], jnp.asarray(labels)), port_losses.acgan_loss(p[4], torch.from_numpy(labels))),
    ]
    for want, got in pairs:
        assert str(want.dtype) == _dtype_name(got) == "float32"
    w = rng.normal(size=(3072,)).astype(np.float32)
    real, fake = rng.uniform(-1, 1, (2, 4, 3072)).astype(np.float32)
    jgp, jslopes = jax_losses.gradient_penalty(
        lambda x: ((x.astype(jnp.bfloat16) @ jnp.asarray(w, jnp.bfloat16)), None),
        jnp.asarray(real), jnp.asarray(fake, jnp.bfloat16), jax.random.PRNGKey(0))
    pgp, pslopes = port_losses.gradient_penalty(
        lambda x: x.to(torch.bfloat16) @ torch.from_numpy(w).to(torch.bfloat16),
        torch.from_numpy(real), torch.from_numpy(fake).to(torch.bfloat16), torch.full((4, 1), 0.3))
    assert str(jgp.dtype) == _dtype_name(pgp) == "float32"
    assert str(jslopes.dtype) == _dtype_name(pslopes) == "float32"


# ------------------------------------------------------------- G and D


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


def test_generator_bf16_matches_jax_and_fp32(params, batch, monkeypatch):
    """G's bf16 output against JAX's bf16 G (4 U) and the fp32 port's
    (12 U), on tanh outputs whose scale is about 1."""
    JaxDraws(monkeypatch)
    gen, _ = params
    _, labels, noise = batch
    default_tpu_policy(True)
    with rng_context(jax.random.PRNGKey(0)), apply_context(gen):
        want = jax_resnet.generator(BATCH, jnp.asarray(labels), noise=jnp.asarray(noise),
                                    cfg=jax_model_cfg(DIM))
    run = lambda: port_resnet.generator(to_port(gen, False), BATCH, torch.from_numpy(labels).long(),
                                        port_model_cfg(DIM), None, noise=torch.from_numpy(noise))
    with precision_policy("bfloat16"):
        got = run()
    fp32 = run()
    assert str(want.dtype) == _dtype_name(got) == "bfloat16" and fp32.dtype == torch.float32
    assert _max_dev(got, want) <= 4 * U
    assert _max_dev(got, fp32) <= 12 * U


@pytest.mark.parametrize("kps", [KP, (1.0, 1.0, 1.0)], ids=["train", "clean"])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_discriminator_bf16_matches_jax_and_fp32(params, batch, kps, in_dtype, monkeypatch):
    """Critic scores, features and ACGAN logits (bf16) against JAX's bf16 D
    with the same masks (4 U) and the fp32 port (12 U); fp32 input (the
    real and fake halves of the critic batch) or bf16 (fakes alone)."""
    draws = JaxDraws(monkeypatch)
    _, disc = params
    real, labels, _ = batch
    default_tpu_policy(True)
    with apply_context(disc):
        want = jax_resnet.discriminator(jnp.asarray(real).astype(in_dtype), jnp.asarray(labels), *kps,
                                        jax_model_cfg(DIM))
    default_tpu_policy(False)
    masks = draws.masks()
    x = torch.from_numpy(real).to(getattr(torch, in_dtype))
    run = lambda: port_resnet.discriminator(to_port(disc, False), x, torch.from_numpy(labels).long(),
                                            kps, port_model_cfg(DIM), InjectedRandomness(masks=masks))
    with precision_policy("bfloat16"):
        got = run()
    fp32 = run()
    for g, w, f in zip(got, want, fp32):
        assert str(w.dtype) == _dtype_name(g) == "bfloat16" and f.dtype == torch.float32
        assert _max_dev(g, w) <= 4 * U
        assert _max_dev(g, f) <= 12 * U


# ---------------------------------------------------------- the substeps


def _trainers():
    jcfg, pcfg = jax_model_cfg(DIM), port_model_cfg(DIM)
    jax_trainer = make_acgan_trainer(
        lambda n, labels, noise=None: jax_resnet.generator(n, labels, noise=noise, cfg=jcfg),
        lambda x, labels, k1, k2, k3: jax_resnet.discriminator(x, labels, k1, k2, k3, jcfg),
        JaxAcganConfig(batch_size=BATCH, critic_iters=N_CRITIC, iters=4, lr=LR),
    )
    port_trainer = AcganTrainer(
        lambda p, n, labels, rand, noise=None: port_resnet.generator(p, n, labels, pcfg, rand, noise=noise),
        lambda p, x, labels, kps, rand: port_resnet.discriminator(p, x, labels, kps, pcfg, rand),
        AcganConfig(batch_size=BATCH, critic_iters=N_CRITIC, iters=4, lr=LR),
    )
    return jax_trainer, port_trainer


def _port_state(jax_state) -> AcganState:
    def opt(o):
        return {"m": from_jax_params({k: np.asarray(v) for k, v in o["m"].items()}),
                "v": from_jax_params({k: np.asarray(v) for k, v in o["v"].items()}),
                "t": float(o["t"])}

    return AcganState(to_port(jax_state.gen_params), to_port(jax_state.disc_params),
                      opt(jax_state.gen_opt), opt(jax_state.disc_opt), int(jax_state.step))


def _assert_adam_close(port: dict, want: dict, start: dict, grads: dict, zero_grad):
    """Within ``2 lr`` everywhere (the substeps here are TF-Adam's first
    updates, which move an element by at most ``lr``); outside the
    zero-gradient parameters the elements that step the other way from
    ``start`` carry at most ``4 U`` of the L1 mass of ``grads``."""
    ours = to_jax_params(port)
    flipped_mass = mass = 0.0
    for name, w in want.items():
        w, s0 = np.asarray(w, np.float64), np.asarray(start[name], np.float64)
        diff = np.abs(ours[name].astype(np.float64) - w)
        assert diff.max() <= 2 * LR + 1e-6, name
        if name not in zero_grad:
            g = np.abs(grads[name].astype(np.float64))
            other_way = np.sign(ours[name] - s0) != np.sign(w - s0)
            flipped_mass += float(np.sum(g[other_way]))
            mass += float(np.sum(g))
    assert flipped_mass <= 4 * U * mass, flipped_mass / mass


@pytest.fixture(scope="module")
def substeps(params):
    """The JAX package's critic substep at step 0 and G substep at step 1,
    in bf16, each jitted once with its draws recorded."""
    gen, disc = params
    rng = np.random.default_rng(7)
    real = rng.integers(0, 256, size=(BATCH, 3072)).astype(np.int32)
    labels = rng.integers(0, 10, size=(BATCH,)).astype(np.int32)
    base_key = jax.random.PRNGKey(123)
    out = {}
    default_tpu_policy(True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            draws = JaxDraws(mp)
            (init_state, step_fn, *_), _ = _trainers()
            state = init_state(gen, disc)
            new, metrics = jax.jit(step_fn.critic_substep, static_argnums=1)(
                state, 0, real, labels, base_key)
            dq = dequant_draws(base_key, 0, N_CRITIC, (BATCH, 3072))[:1]
            out["critic"] = (state, new, metrics, draws.injected(dq), real, labels)
        with pytest.MonkeyPatch.context() as mp:
            draws = JaxDraws(mp)
            (init_state, step_fn, *_), _ = _trainers()
            state = init_state(gen, disc)._replace(step=jnp.int32(1))
            new, g_cost = jax.jit(step_fn.gen_substep)(state, base_key)
            out["gen"] = (state, new, g_cost, draws.injected())
    finally:
        default_tpu_policy(False)
    return out


def _injected_copy(rand: InjectedRandomness) -> InjectedRandomness:
    return InjectedRandomness(masks=rand._masks, noises=rand._noises, label_keys=rand._label_keys,
                              gp_keys=rand._gp_keys, dequant=rand._dequant)


def test_critic_substep_bf16_matches_jax_and_fp32(substeps):
    """One critic substep (CT pair, clean pass, GP double backward, TF-Adam
    step) in bf16: its losses against JAX's bf16 substep and the fp32
    port's (4 U); its parameters as ``_assert_adam_close`` says."""
    state0, want_state, want, rand, real, labels = substeps["critic"]
    zero_grad = port_resnet.zero_grad_params(port_model_cfg(DIM))
    _, trainer = _trainers()
    runs = {}
    for policy in ("bfloat16", "float32"):
        state = _port_state(state0)
        r = _injected_copy(rand)
        with precision_policy(policy):
            metrics = trainer.critic_substep(state, torch.from_numpy(real.astype(np.uint8)),
                                             torch.from_numpy(labels).long(), r)
        assert r.exhausted()
        runs[policy] = (state, metrics)
    state, metrics = runs["bfloat16"]
    fp32_state, fp32_metrics = runs["float32"]
    for k in ("disc_cost", "gp", "ct", "acgan"):
        np.testing.assert_allclose(float(metrics[k]), float(want[k]), rtol=4 * U, err_msg=k)
        np.testing.assert_allclose(float(metrics[k]), float(fp32_metrics[k]), rtol=4 * U, err_msg=k)
    assert abs(float(metrics["wgan"]) - float(want["wgan"])) <= 4 * U
    assert abs(float(metrics["wgan"]) - float(fp32_metrics["wgan"])) <= 4 * U
    assert all(v.dtype == torch.float32 for v in state.disc_params.values())
    grads = to_jax_params(fp32_state.disc_opt["m"])
    start = state0.disc_params
    _assert_adam_close(state.disc_params, want_state.disc_params, start, grads, zero_grad)
    _assert_adam_close(state.disc_params, to_jax_params(fp32_state.disc_params), start, grads, zero_grad)


def test_gen_substep_bf16_matches_jax_and_fp32(substeps):
    """One G substep at step 1 in bf16: the cost against JAX's bf16 and the
    fp32 port's (4 U); G's parameters as ``_assert_adam_close`` says."""
    state0, want_state, want_cost, rand = substeps["gen"]
    zero_grad = port_resnet.zero_grad_params(port_model_cfg(DIM))
    _, trainer = _trainers()
    runs = {}
    for policy in ("bfloat16", "float32"):
        state = _port_state(state0)
        r = _injected_copy(rand)
        with precision_policy(policy):
            cost = trainer.gen_substep(state, r)
        assert r.exhausted() and cost.dtype == torch.float32
        runs[policy] = (state, float(cost))
    (state, cost), (fp32_state, fp32_cost) = runs["bfloat16"], runs["float32"]
    np.testing.assert_allclose(cost, float(want_cost), rtol=4 * U)
    np.testing.assert_allclose(cost, fp32_cost, rtol=4 * U)
    grads = to_jax_params(fp32_state.gen_opt["m"])
    start = state0.gen_params
    _assert_adam_close(state.gen_params, want_state.gen_params, start, grads, zero_grad)
    _assert_adam_close(state.gen_params, to_jax_params(fp32_state.gen_params), start, grads, zero_grad)
