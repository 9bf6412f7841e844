"""The JAX package's semi-supervised MNIST step, eager against jitted.

    JAX_PLATFORMS=cpu python tests/torch_ssl_jit_gap.py

One ``step_fn`` at full width and batch 8 from ``init_context(0)``'s
params, on ``default_rng(3)`` inputs, with the same injected draws both
ways (``test_torch_semisup.SslDraws``, seed 0).  Prints the draws of each
run and, for the tensors where they differ most, the largest gap of Adam's
first moment (``(1 - mom1)`` times the gradient) over that tensor's largest
magnitude, its element, both values.  ``test_torch_semisup``'s trainer test
compares the port with the eager step.
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
from ctgan_tpu.core import split_params  # noqa: E402


def first_moments(jit: bool) -> tuple[dict, list]:
    mp = pytest.MonkeyPatch()
    draws = t.SslDraws(mp)
    params = t._tiny_jax_params("mnist")
    draws.draws.clear()
    n = 8
    rng = np.random.default_rng(3)
    x = lambda: rng.uniform(-0.5, 0.5, (n, 784)).astype(np.float32)  # noqa: E731
    x_lab, labels, x_unl, x_unl2 = x(), rng.integers(0, 10, n), x(), x()
    init_state, step_fn, _, _ = t.jax_make_ssl_trainer(t.jc.mnist_ssl_classifier, t.jc.mnist_ssl_generator,
                                                       t.JaxSslConfig(variant="mnist", lr=3e-3, lambda_2=0.1))
    disc, gen, _ = split_params({k: jnp.asarray(v) for k, v in params.items()}, "Classifier", "Generator")
    step = jax.jit(step_fn) if jit else step_fn
    state, _ = step(init_state(disc, gen), jnp.asarray(x_lab), jnp.asarray(labels), jnp.asarray(x_unl),
                    jnp.asarray(x_unl2), None, jax.random.PRNGKey(0))
    mp.undo()
    moments = {k: np.asarray(v) for opt in (state.disc_opt, state.gen_opt) for k, v in opt["m"].items()}
    return moments, [(d[0], getattr(d[1], "shape", None)) for d in draws.draws]


def main() -> None:
    (eager, eager_draws), (jitted, jit_draws) = first_moments(False), first_moments(True)
    print("draws equal:", eager_draws == jit_draws, len(eager_draws))
    rows = []
    for k, e in eager.items():
        gap = np.abs(e - jitted[k])
        i = np.unravel_index(np.argmax(gap), gap.shape)
        scale = float(np.abs(e).max())
        rows.append((float(gap.max()) / max(scale, 1e-30), k, tuple(int(v) for v in i), e.shape,
                     float(e[i]), float(jitted[k][i]), scale))
    for share, k, i, shape, e, j, scale in sorted(rows, reverse=True)[:6]:
        print(f"{k}{list(i)} of {shape}: eager {e:.4g}, jitted {j:.4g}, gap {share:.3g} of the largest |m| {scale:.3g}")


if __name__ == "__main__":
    main()
