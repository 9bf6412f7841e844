"""The JAX package's semi-supervised MNIST step, eager against jitted,
and both against the step in float64.

    JAX_PLATFORMS=cpu python tests/torch_ssl_jit_gap.py

One ``step_fn`` at full width and batch 8 from ``init_context(0)``'s
params, on ``default_rng(3)`` inputs, with the same injected draws both
ways (``test_torch_semisup.SslDraws``, seed 0).  Prints the draws of each
run and, for the tensors where they differ most, the largest gap of Adam's
first moment (``(1 - mom1)`` times the gradient) over that tensor's largest
magnitude, its element, both values.  ``test_torch_semisup``'s trainer test
compares the port with the eager step.

Then the reference nearest exact arithmetic: the port's step in float64
(every op of the port keeps float64) on the same draws, and the JAX step
eager with ``jax_enable_x64`` on float64 params and inputs, G's latent
drawn in fp32 from its key as in the other runs (its norms and other
explicit casts still compute in fp32).  For G's and D's first
moments it prints each run's largest gap to the port's float64 step, over
each tensor's largest magnitude: JAX eager and jitted in fp32, the port in
fp32, JAX in float64.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import conftest  # noqa: E402,F401  (JAX on the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import test_torch_semisup as t  # noqa: E402
import torch  # noqa: E402
from ctgan_tpu.core import split_params  # noqa: E402
from ctgan_tpu_torch.bridge import from_jax_params, to_jax_params  # noqa: E402
from ctgan_tpu_torch.train import SslConfig, make_ssl_trainer  # noqa: E402

LR, LAMBDA_2, N = 3e-3, 0.1, 8


def _inputs(dtype) -> tuple:
    rng = np.random.default_rng(3)
    x = lambda: rng.uniform(-0.5, 0.5, (N, 784)).astype(np.float32).astype(dtype)  # noqa: E731
    x_lab, labels, x_unl, x_unl2 = x(), rng.integers(0, 10, N), x(), x()
    return x_lab, labels, x_unl, x_unl2


def first_moments(jit: bool, dtype=np.float32) -> tuple[dict, list]:
    """Adam's first moments after the JAX step (eager or jitted) in
    ``dtype``, and the draws it made."""
    mp = pytest.MonkeyPatch()
    draws = t.SslDraws(mp)
    params = t._tiny_jax_params("mnist")
    draws.draws.clear()
    if dtype == np.float64:  # under x64 G's latent draw would be float64: other numbers from the same key
        uniform = jax.random.uniform
        mp.setattr(jax.random, "uniform", lambda key, shape=(), dtype=None, **kw: uniform(
            key, shape, jnp.float32, **kw).astype(jnp.float64))
    x_lab, labels, x_unl, x_unl2 = _inputs(dtype)
    init_state, step_fn, _, _ = t.jax_make_ssl_trainer(t.jc.mnist_ssl_classifier, t.jc.mnist_ssl_generator,
                                                       t.JaxSslConfig(variant="mnist", lr=LR, lambda_2=LAMBDA_2))
    disc, gen, _ = split_params({k: jnp.asarray(v.astype(dtype)) for k, v in params.items()}, "Classifier",
                                "Generator")
    step = jax.jit(step_fn) if jit else step_fn
    state, _ = step(init_state(disc, gen), jnp.asarray(x_lab), jnp.asarray(labels), jnp.asarray(x_unl),
                    jnp.asarray(x_unl2), None, jax.random.PRNGKey(0))
    mp.undo()
    moments = {k: np.asarray(v, np.float64) for opt in (state.disc_opt, state.gen_opt) for k, v in opt["m"].items()}
    return moments, list(draws.draws)


def port_first_moments(draws: list, dtype: torch.dtype) -> dict:
    """The port's step in ``dtype`` on the JAX step's draws."""
    params = t._tiny_jax_params("mnist")
    trainer = make_ssl_trainer(t.pc.mnist_ssl_classifier, t.pc.mnist_ssl_generator,
                               SslConfig(variant="mnist", lr=LR, lambda_2=LAMBDA_2))
    pd, pg, _ = split_params({k: v.to(dtype) for k, v in from_jax_params(params).items()}, "Classifier",
                             "Generator")
    state = trainer.init_state(pd, pg)
    x_lab, labels, x_unl, x_unl2 = (torch.from_numpy(a) for a in _inputs(np.float64))
    rand = t.InjectedSsl(list(draws))
    trainer.step(state, x_lab.to(dtype), labels, x_unl.to(dtype), x_unl2.to(dtype), None, rand)
    assert rand.exhausted()
    return {k: np.asarray(v, np.float64) for opt in (state.disc_opt, state.gen_opt)
            for k, v in to_jax_params(opt["m"]).items()}


def largest_share(got: dict, want: dict, network: str) -> tuple[float, str]:
    """The largest gap over a tensor's largest magnitude, over the tensors
    of ``network`` ("Classifier" or "Generator"), and that tensor."""
    return max((float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()), 1e-30), k)
               for k, w in want.items() if k.startswith(network))


def main() -> None:
    (eager, eager_draws), (jitted, jit_draws) = first_moments(False), first_moments(True)
    shapes = lambda draws: [(d[0], getattr(d[1], "shape", None)) for d in draws]  # noqa: E731
    print("draws equal:", shapes(eager_draws) == shapes(jit_draws), len(eager_draws))
    rows = []
    for k, e in eager.items():
        gap = np.abs(e - jitted[k])
        i = np.unravel_index(np.argmax(gap), gap.shape)
        scale = float(np.abs(e).max())
        rows.append((float(gap.max()) / max(scale, 1e-30), k, tuple(int(v) for v in i), e.shape,
                     float(e[i]), float(jitted[k][i]), scale))
    for share, k, i, shape, e, j, scale in sorted(rows, reverse=True)[:6]:
        print(f"{k}{list(i)} of {shape}: eager {e:.4g}, jitted {j:.4g}, gap {share:.3g} of the largest |m| {scale:.3g}")

    exact = port_first_moments(eager_draws, torch.float64)
    runs = {"JAX eager fp32": eager, "JAX jitted fp32": jitted,
            "port fp32": port_first_moments(eager_draws, torch.float32)}
    jax.config.update("jax_enable_x64", True)
    runs["JAX eager float64"] = first_moments(False, np.float64)[0]
    for name, moments in runs.items():
        for network in ("Classifier", "Generator"):
            share, k = largest_share(moments, exact, network)
            print(f"{name} against the port in float64, {network}: largest gap {share:.3g} of |m| ({k})")


if __name__ == "__main__":
    main()
