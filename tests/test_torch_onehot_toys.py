"""The port's one-hot toys (``ctgan_tpu_torch/apps/onehot_toys.py``) against
``ctgan_tpu/apps/onehot_toys.py`` on the CPU, with JAX's draws (noise,
Gumbel uniforms, GP alphas) and the same one-hot batches injected.

Tolerances: fp32 products in other orders, so G, the critic and the
autoencoder within 1e-5 relative and 1e-6 absolute (the Gumbel softmax at
temperature 0.1 amplifies its logits' rounding tenfold: 1e-5 absolute);
after a step, TF-Adam moves an element by about lr * sign(g), so parameters
are held with ``adam_mismatches`` (atol 1e-6).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctgan_tpu.apps import onehot_toys as jax_toys
from ctgan_tpu.core import apply_context, init_context, rng_context
from ctgan_tpu.core import rng as jax_rng
from ctgan_tpu.utils import MetricLogger as JaxLogger

from ctgan_tpu_torch.apps import onehot_toys as toys
from ctgan_tpu_torch.bridge import from_jax_params, to_jax_params
from ctgan_tpu_torch.train.optim import adam_mismatches

import torch_parity  # noqa: F401  (one intra-op thread per test worker)

SMALL = dict(BATCH_SIZE=8, OUTPUT_DIM=16, DIM=12, seed=3)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32))


def _jax_draws(key, batch: int, output_dim: int, gp: bool) -> dict:
    """The draws the JAX toy makes under ``rng_context(key)``, in its order."""
    with rng_context({"default": key}):
        k_noise, k_gumbel = jax_rng.next_key("noise"), jax_rng.next_key("gumbel")
        k_gp = jax_rng.next_key("gp") if gp else None
    out = {"noise": jax.random.normal(k_noise, (batch, 128)),
           "u": jax.random.uniform(k_gumbel, (batch, output_dim), minval=0.1, maxval=0.99)}
    if gp:
        out["alpha"] = jax.random.uniform(k_gp, (batch, 1), jnp.float32)
    return out


def test_params_are_the_jax_packages():
    cfg = toys.Config(**SMALL)
    with init_context(seed=cfg.seed) as ctx:
        with rng_context(jax.random.PRNGKey(0)):
            jax_toys.onehot_critic(jax_toys.onehot_generator(2, cfg.OUTPUT_DIM, cfg.DIM), cfg.OUTPUT_DIM, cfg.DIM)
    got = toys.init_params(cfg)
    assert list(got) == list(ctx.params)
    for k, v in ctx.params.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    with init_context(seed=1) as ctx:
        jax_toys.autoencoder(jnp.zeros((2, 256)), 256)
    got = toys.init_params(toys.Config(which="ae", seed=1))
    assert list(got) == list(ctx.params)
    for k, v in ctx.params.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_generator_critic_and_autoencoder_match_jax():
    cfg = toys.Config(**SMALL)
    params = toys.init_params(cfg)
    port = from_jax_params(params)
    key = jax.random.PRNGKey(7)
    draws = _jax_draws(key, 8, cfg.OUTPUT_DIM, gp=False)
    with rng_context({"default": key}), apply_context(params):
        want_fake = jax_toys.onehot_generator(8, cfg.OUTPUT_DIM, cfg.DIM)
        want_logits, want_feats = jax_toys.onehot_critic(want_fake, cfg.OUTPUT_DIM, cfg.DIM)
    fake = toys.onehot_generator(port, _t(draws["noise"]), _t(draws["u"]))
    np.testing.assert_allclose(fake.numpy(), np.asarray(want_fake), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fake.sum(1).numpy(), 1.0, atol=1e-5)
    logits, feats = toys.onehot_critic(port, _t(want_fake))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), rtol=1e-5, atol=1e-6)
    ae = toys.init_params(toys.Config(which="ae"))
    x = np.eye(256, dtype=np.float32)[np.random.default_rng(0).integers(0, 256, 8)]
    with apply_context(ae):
        want = jax_toys.autoencoder(jnp.asarray(x), 256)
    np.testing.assert_allclose(toys.autoencoder(from_jax_params(ae), _t(x)).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_one_wgan_iteration_matches_jax(tmp_path):
    """JAX's ``run_wgan`` for one iteration against ``WganToy.step`` with
    JAX's draws: one D update (WGAN-GP, lambda 10), then one G update."""
    cfg = toys.Config(ITERS=1, out_dir=str(tmp_path / "jax"), **SMALL)
    want_g, want_d = jax_toys.run_wgan(jax_toys.Config(**{k: getattr(cfg, k) for k in (
        "ITERS", "BATCH_SIZE", "OUTPUT_DIM", "DIM", "seed")}), JaxLogger(None))
    key = jax.random.PRNGKey(cfg.seed)
    d = _jax_draws(jax.random.fold_in(key, 0), cfg.BATCH_SIZE, cfg.OUTPUT_DIM, gp=True)
    g = _jax_draws(jax.random.fold_in(key, 1), cfg.BATCH_SIZE, cfg.OUTPUT_DIM, gp=False)
    draws = {"noise_d": _t(d["noise"]), "u_d": _t(d["u"]), "alpha": _t(d["alpha"]),
             "noise_g": _t(g["noise"]), "u_g": _t(g["u"])}
    real = _t(toys.onehot_batch(np.random.default_rng(cfg.seed), cfg.BATCH_SIZE, cfg.OUTPUT_DIM))
    toy = toys.WganToy(cfg, "cpu")
    dc, gc = toy.step(real, draws, 0)
    assert math.isfinite(float(dc)) and math.isfinite(float(gc))
    # A hidden unit of D whose leaky ReLU keeps one slope on every real and
    # fake example has a bias gradient of exactly 0 (the WGAN means cancel,
    # and the GP's input gradient does not depend on the bias): rounding
    # leaves it at +-1e-9 on either side, which Adam turns into +-lr.
    zero_grad = ["Discriminator.1.Linear.b", "Discriminator.2.Linear.b"]
    for got, want in ((toy.gen, want_g), (toy.disc, want_d)):
        want = {k: np.asarray(v) for k, v in want.items()}
        assert not adam_mismatches(to_jax_params(got), want, lr=1e-4, n_updates=1, atol=1e-6, zero_grad=zero_grad)


def test_one_autoencoder_iteration_matches_jax():
    cfg = toys.Config(which="ae", ITERS=1, BATCH_SIZE=8, seed=2)
    want = jax_toys.run_ae(jax_toys.Config(which="ae", ITERS=1, BATCH_SIZE=8, seed=2), JaxLogger(None))
    toy = toys.AeToy(cfg, "cpu")
    real = _t(toys.onehot_batch(np.random.default_rng(cfg.seed), cfg.BATCH_SIZE, toys.AE_DIM))
    costs = [float(toy.step(real, 0)) for _ in range(toys.AE_STEPS)]
    assert costs[-1] < costs[0]
    want = {k: np.asarray(v) for k, v in want.items()}
    assert not adam_mismatches(to_jax_params(toy.params), want, lr=1e-4, n_updates=toys.AE_STEPS, atol=1e-6)


@pytest.mark.parametrize("which", ["wgan", "ae"])
def test_main_runs_on_the_cpu(tmp_path, which, capsys):
    """``main`` at small ``ITERS``: the logger prints every 100 iterations
    and writes ``log.pkl``; costs finite."""
    cfg = toys.Config(which=which, ITERS=200, BATCH_SIZE=16, out_dir=str(tmp_path),
                      **({"OUTPUT_DIM": 32, "DIM": 16} if which == "wgan" else {}))
    toys.main(cfg=cfg, device="cpu")
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("iter ")]
    assert [line.split("\t")[0] for line in lines] == ["iter 100", "iter 200"]
    costs = [float(v) for line in lines for v in line.split("\t")[2::2]]
    assert costs and all(math.isfinite(c) for c in costs)
    assert (tmp_path / "log.pkl").is_file()


def test_config_defaults_are_the_jax_apps_and_the_card_is_the_default(tmp_path):
    assert toys.Config().__dict__ | {"out_dir": ""} == jax_toys.Config().__dict__ | {"out_dir": ""}
    assert toys.parse_config(["--which", "ae", "--ITERS", "3"]).which == "ae"
    with pytest.raises(ValueError, match="unknown toy"):
        toys.main(cfg=toys.Config(which="gan", out_dir=str(tmp_path)), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            toys.main(cfg=toys.Config(ITERS=1, out_dir=str(tmp_path)))
