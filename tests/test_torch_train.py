"""``ctgan_tpu_torch`` trainer against ``ctgan_tpu`` on the CPU: TF-Adam and
the LR schedule, and whole 1G+2D iterations of the flagship step with every
random draw injected from the JAX side (tests/torch_parity.py).  dim 16,
batch 4, 2 critic iterations."""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ctgan_tpu.train import AcganConfig as JaxAcganConfig
from ctgan_tpu.train import make_acgan_trainer
from ctgan_tpu.train import optim as jax_optim
from ctgan_tpu.train import schedules as jax_schedules
from ctgan_tpu.models import resnet_cifar as jax_resnet

from ctgan_tpu_torch.bridge import from_jax_params, to_jax_params
from ctgan_tpu_torch.models import resnet_cifar as port_resnet
from ctgan_tpu_torch.train import Adam, AcganConfig, AcganState, AcganTrainer, linear_decay
from ctgan_tpu_torch.train.optim import adam_mismatches

from torch_parity import JaxDraws, dequant_draws, jax_init_params, jax_model_cfg, port_model_cfg, to_port

DIM, BATCH, N_CRITIC, ITERS, LR = 16, 4, 2, 4, 2e-4


def test_linear_decay_matches_jax():
    ours, theirs = linear_decay(2e-4, 7), jax_schedules.linear_decay(2e-4, 7)
    for step in range(10):
        assert ours(step) == np.float32(theirs(step)), step


def test_tf_adam_matches_jax():
    """Six steps of TF-Adam (beta1 0, as the flagship) on random parameters
    and gradients, with the decaying LR: equal to fp32 rounding (rtol 1e-6).
    torch.optim.Adam would differ: it adds eps after bias correction."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    lr = jax_schedules.linear_decay(1e-3, 10)
    j_opt = jax_optim.adam(lr, 0.0, 0.9)
    j_state, j_params = j_opt.init(params), {k: jnp.asarray(v) for k, v in params.items()}
    p_opt = Adam(linear_decay(1e-3, 10), 0.0, 0.9)
    p_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    p_state = p_opt.init(p_params)
    for step in range(6):
        grads = {k: rng.normal(size=s).astype(np.float32) * 10.0 ** -step for k, s in shapes.items()}
        j_params, j_state = j_opt.update({k: jnp.asarray(g) for k, g in grads.items()}, j_state, j_params, step)
        p_opt.update({k: torch.from_numpy(g) for k, g in grads.items()}, p_state, p_params, step)
        assert p_state["t"] == float(j_state["t"])
        for k in shapes:
            np.testing.assert_allclose(p_params[k].numpy(), np.asarray(j_params[k]), rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(p_state["v"][k].numpy(), np.asarray(j_state["v"][k]), rtol=1e-6)


def _trainers():
    jcfg, pcfg = jax_model_cfg(DIM), port_model_cfg(DIM)
    jax_trainer = make_acgan_trainer(
        lambda n, labels, noise=None: jax_resnet.generator(n, labels, noise=noise, cfg=jcfg),
        lambda x, labels, k1, k2, k3: jax_resnet.discriminator(x, labels, k1, k2, k3, jcfg),
        JaxAcganConfig(batch_size=BATCH, critic_iters=N_CRITIC, iters=ITERS, lr=LR),
    )
    port_trainer = AcganTrainer(
        lambda p, n, labels, rand, noise=None: port_resnet.generator(p, n, labels, pcfg, rand, noise=noise),
        lambda p, x, labels, kps, rand: port_resnet.discriminator(p, x, labels, kps, pcfg, rand),
        AcganConfig(batch_size=BATCH, critic_iters=N_CRITIC, iters=ITERS, lr=LR),
    )
    return jax_trainer, port_trainer


def _port_state(jax_state) -> AcganState:
    def opt(o):
        return {"m": from_jax_params({k: np.asarray(v) for k, v in o["m"].items()}),
                "v": from_jax_params({k: np.asarray(v) for k, v in o["v"].items()}),
                "t": float(o["t"])}

    return AcganState(to_port(jax_state.gen_params), to_port(jax_state.disc_params),
                      opt(jax_state.gen_opt), opt(jax_state.disc_opt), int(jax_state.step))


def assert_params_close(port: dict, jax_params: dict, zero_grad=(), n_updates=0):
    """Port params, converted back to the JAX layout, against JAX's to atol
    1e-6, with ``adam_mismatches``' allowance for Adam steps on gradients
    that are zero up to rounding (up to 2 * lr per update)."""
    ours = to_jax_params(port)
    theirs = {k: np.asarray(v) for k, v in jax_params.items()}
    assert not adam_mismatches(ours, theirs, lr=LR, n_updates=n_updates, zero_grad=zero_grad)


def test_iterations_match_jax(monkeypatch):
    """Two whole iterations of the jitted JAX step (step 0, whose G update
    is dropped, then step 1) against the port started from the same state.
    Metrics to rtol 1e-4; params to atol 1e-6 (lr is 2e-4, so a step is
    resolved to 0.5%), with the allowance of ``adam_mismatches`` for Adam
    steps on gradients that are zero up to rounding."""
    gen, disc = jax_init_params(DIM, seed=5)
    draws = JaxDraws(monkeypatch)
    (init_state, step_fn, *_), port_trainer = _trainers()
    rng = np.random.default_rng(7)
    real = rng.integers(0, 256, size=(N_CRITIC, BATCH, 3072)).astype(np.int32)
    labels = rng.integers(0, 10, size=(N_CRITIC, BATCH)).astype(np.int32)
    base_key = jax.random.PRNGKey(123)
    jstep = jax.jit(step_fn)
    states = [init_state(gen, disc)]
    metrics = []
    for _ in range(2):
        s, m = jstep(states[-1], real, labels, base_key)
        states.append(s)
        metrics.append(m)
    assert len(draws.dropouts) == 3 + 6 * N_CRITIC  # traced once: same draws both steps
    zero_grad = port_resnet.zero_grad_params(port_model_cfg(DIM))

    for step in (0, 1):
        state = _port_state(states[step])
        rand = draws.injected(dequant_draws(base_key, step, N_CRITIC, (BATCH, 3072)))
        p_metrics = port_trainer.step(state, torch.from_numpy(real.astype(np.uint8)),
                                      torch.from_numpy(labels).long(), rand)
        assert rand.exhausted()
        assert state.step == step + 1
        want = states[step + 1]
        assert set(p_metrics) == set(metrics[step])
        for k, v in metrics[step].items():
            np.testing.assert_allclose(float(p_metrics[k]), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
        assert_params_close(state.disc_params, want.disc_params, zero_grad, n_updates=N_CRITIC)
        assert_params_close(state.gen_params, want.gen_params, zero_grad, n_updates=step)
        assert state.gen_opt["t"] == float(want.gen_opt["t"]) == step
        assert state.disc_opt["t"] == float(want.disc_opt["t"])


def test_adam_mismatches_allows_flips_only_where_due():
    rng = np.random.default_rng(1)
    want = {"w": rng.normal(size=(50, 50)), "b": rng.normal(size=(8,))}
    got = {k: v.copy() for k, v in want.items()}
    assert adam_mismatches(got, want, lr=LR, n_updates=1) == []
    got["w"][0, 0] += 2 * LR  # one flipped element in 2500: allowed
    got["b"] -= 2 * LR        # every element of a zero-gradient parameter
    assert adam_mismatches(got, want, lr=LR, n_updates=1, zero_grad=["b"]) == []
    assert adam_mismatches(got, want, lr=LR, n_updates=1)        # b not declared
    got["w"][:10, 0] += 2 * LR                                    # 11 flips in w
    assert adam_mismatches(got, want, lr=LR, n_updates=1, zero_grad=["b"])
    got = {k: v.copy() for k, v in want.items()}
    got["w"][3, 3] += 3 * LR                                      # beyond any flip
    assert adam_mismatches(got, want, lr=LR, n_updates=1)
