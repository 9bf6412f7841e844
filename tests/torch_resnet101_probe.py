"""The measurement behind ``tests/test_torch_resnet101_step.py``'s bound,
on the CPU:

    python tests/torch_resnet101_probe.py

The 64 px app's ``ARCH resnet101`` critic substep (wgan-ct, dim 8, batch
4, one critic iteration; at step 0, and at step 1 after one jitted JAX
iteration), against the port's substep in float64 (the port computes in
float64 when its operands are float64, ``ctgan_tpu_torch/core/matmul.py``).
Each arm's ``disc_cost`` and gradient penalty are given as a share of the
float64 value, its parameter gradients as a share of a tensor's scale
(``tests/torch_precision_probe.py``'s measure; JAX's gradients read from
Adam's first moment).  The arms:

1. the JAX package's jitted ``critic_substep`` and the port's, both fp32;
2. the port's suspects, each computed in float64 inside the otherwise fp32
   step: G's batch norm (the two-pass CPU form, ``ops/norm.py``), the
   bottleneck block's TF-SAME 3x3 transposed conv
   (``ops/conv.py::deconv2d``) and D's layer norm;
3. the split: G in float64 with D in fp32, G in fp32 with D in float64,
   and the float64 step on G's images rounded to fp32 once;
4. the float64 step on G's images plus the fp32 G's own error (the fp32
   images' difference from the float64 ones), whole and halved, and plus
   seeded Gaussian noise of 1e-6 (the fp32 G's error is about 5e-7 RMS).

And at step 1 (step 0 drops G's update, so JAX's G gradients cannot be
read there) the G substep's cost and G's gradients: the JAX package's and
the port's fp32 against the port's float64, and the float64 substep on
G's images plus the same seeded noise.

Every draw of the JAX side is injected into the port (tests/torch_parity.py).
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from ctgan_tpu.core import apply_context  # noqa: E402
from ctgan_tpu.train import GanConfig as JaxGanConfig  # noqa: E402
from ctgan_tpu.train import make_gan_trainer  # noqa: E402
from ctgan_tpu_torch.bridge import to_jax_params  # noqa: E402
from ctgan_tpu_torch.models import blocks as port_blocks  # noqa: E402
from ctgan_tpu_torch.models import good64 as port_good64  # noqa: E402
from ctgan_tpu_torch.train import GanConfig, GanTrainer  # noqa: E402

import test_torch_gan_trainer as trainer_tests  # noqa: E402
from test_torch_resnet101_step import resnet101_net  # noqa: E402
from torch_parity import JaxDraws  # noqa: E402
from torch_precision_probe import _Patch, _grad_dev, _port_critic  # noqa: E402

MODE, BATCH = "wgan-ct", 4
NOISE_SEEDS = range(6)

SUSPECTS = {
    "G's batch norm": (port_good64, "batchnorm"),
    "the 3x3 transposed conv": (port_blocks, "deconv2d"),
    "D's layer norm": (port_good64, "layernorm"),
}


@contextlib.contextmanager
def _in_float64(module, name: str):
    """``module.name`` computed in float64, its result cast back."""
    original = getattr(module, name)

    def wide(x, *args):
        return original(x.double(), *(a.double() if isinstance(a, torch.Tensor) else a for a in args)).to(x.dtype)

    setattr(module, name, wide)
    try:
        yield
    finally:
        setattr(module, name, original)


def _wide(p: dict) -> dict:
    return {k: v.double() for k, v in p.items()}


class _Cast:
    """A provider handing out ``rand``'s noise in ``dtype``."""

    def __init__(self, rand, dtype):
        self._rand, self._dtype = rand, dtype

    def __getattr__(self, name):
        return getattr(self._rand, name)

    def noise(self, n, d):
        return self._rand.noise(n, d).to(self._dtype)


def _port_gen(trainer: GanTrainer, state, draws, dtype) -> tuple[dict, dict]:
    """The port's G cost and G's gradients in ``dtype`` on the JAX side's
    draws of one G substep."""
    cast = lambda p: {k: v.detach().to(dtype).requires_grad_(True) for k, v in p.items()}
    gen = cast(state.gen_params)
    cost = trainer.gen_loss(gen, cast(state.disc_params), _Cast(draws.injected(), dtype))
    grads = torch.autograd.grad(cost, list(gen.values()))
    return {"gen_cost": float(cost.detach())}, to_jax_params(dict(zip(gen, grads)))


def probe_gen(step: int = 1) -> dict[str, tuple[float, float]]:
    """``{arm: (gen_cost gap, G gradient gap)}`` of the G substep at
    ``step`` against the port in float64."""
    net = resnet101_net()
    gen, disc = net.params(5)
    draws = JaxDraws(_Patch(), model=net.jax_model)
    (jax_gen, jax_disc), (port_gen, port_disc) = net.jax_fns, net.port_fns
    cfg = dict(mode=MODE, batch_size=BATCH, critic_iters=1, lr_decay=True, iters=10)
    init_state, step_fn, _, _ = make_gan_trainer(jax_gen, jax_disc, JaxGanConfig(**cfg))
    real = np.random.default_rng(7).uniform(-1, 1, size=(1, BATCH, 3 * 64 * 64)).astype(np.float32)
    key = jax.random.PRNGKey(123)
    jgen, jcrit = jax.jit(step_fn.gen_substep), jax.jit(step_fn.critic_substep)
    state = init_state(gen, disc)
    for _ in range(step):
        state = step_fn.bump_step(jcrit(jgen(state, key)[0], 0, real[0], key)[0])
    after_g, jax_cost = jgen(state, key)
    beta1 = 0.5
    jax_grads = {k: (np.asarray(after_g.gen_opt["m"][k], np.float64)
                     - beta1 * np.asarray(state.gen_opt["m"][k], np.float64)) / (1 - beta1)
                 for k in after_g.gen_opt["m"]}
    port_state = trainer_tests._port_state(state)

    def run(dtype, gen_fn=port_gen):
        return _port_gen(GanTrainer(gen_fn, port_disc, GanConfig(**cfg)), port_state, draws, dtype)

    ref, ref_grads = run(torch.float64)
    arms = {"JAX fp32": ({"gen_cost": float(jax_cost)}, jax_grads), "port fp32": run(torch.float32)}
    for seed in NOISE_SEEDS:
        shift = 1e-6 * torch.randn((BATCH, 3 * 64 * 64), generator=torch.Generator().manual_seed(seed),
                                   dtype=torch.float64)
        arms[f"port float64, G's images + 1e-6 N(0, 1), seed {seed}"] = run(
            torch.float64, lambda p, n, rand, noise=None: port_gen(p, n, rand, noise=noise) + shift)
    gap = lambda m: abs(m["gen_cost"] - ref["gen_cost"]) / abs(ref["gen_cost"])
    return {name: (gap(m), _grad_dev(g, ref_grads)) for name, (m, g) in arms.items()}


def probe(step: int) -> dict[str, tuple[float, float, float]]:
    """``{arm: (disc_cost gap, gp gap, gradient gap)}`` against the port in
    float64, at ``step``."""
    net = resnet101_net()
    gen, disc = net.params(5)
    draws = JaxDraws(_Patch(), model=net.jax_model)
    (jax_gen, jax_disc), (port_gen, port_disc) = net.jax_fns, net.port_fns
    cfg = dict(mode=MODE, batch_size=BATCH, critic_iters=1, lr_decay=True, iters=10)
    init_state, step_fn, _, _ = make_gan_trainer(jax_gen, jax_disc, JaxGanConfig(**cfg))
    real = np.random.default_rng(7).uniform(-1, 1, size=(1, BATCH, 3 * 64 * 64)).astype(np.float32)
    key = jax.random.PRNGKey(123)
    jgen, jcrit = jax.jit(step_fn.gen_substep), jax.jit(step_fn.critic_substep)
    state = init_state(gen, disc)
    for _ in range(step):
        state = step_fn.bump_step(jcrit(jgen(state, key)[0], 0, real[0], key)[0])
    after_g, _ = jgen(state, key)
    after_d, jax_metrics = jcrit(after_g, 0, real[0], key)
    beta1 = 0.5  # TF-Adam's first moment: m = beta1 m_before + (1 - beta1) g
    jax_grads = {k: (np.asarray(after_d.disc_opt["m"][k], np.float64)
                     - beta1 * np.asarray(after_g.disc_opt["m"][k], np.float64)) / (1 - beta1)
                 for k in after_d.disc_opt["m"]}
    port_state = trainer_tests._port_state(after_g)

    def run(dtype, gen_fn=port_gen, disc_fn=port_disc):
        return _port_critic(GanTrainer(gen_fn, disc_fn, GanConfig(**cfg)), port_state, real[0], draws, dtype)

    images = {}

    def keep_images(p, n, rand, noise=None):
        images[p["Generator.Out.Filters"].dtype] = out = port_gen(p, n, rand, noise=noise)
        return out

    ref, ref_grads = run(torch.float64, keep_images)
    arms = {"JAX fp32": ({k: float(v) for k, v in jax_metrics.items()}, jax_grads),
            "port fp32": run(torch.float32, keep_images)}
    for name, (module, attr) in SUSPECTS.items():
        with _in_float64(module, attr):
            arms[f"port fp32, {name} in float64"] = run(torch.float32)
    arms["port, G in float64, D in fp32"] = run(
        torch.float32, lambda p, n, rand, noise=None: port_gen(_wide(p), n, rand,
                                                               noise=rand.noise(n, 128).double()).float())
    arms["port, G in fp32, D in float64"] = run(
        torch.float32, disc_fn=lambda p, x, rand: tuple(t.float() for t in port_disc(_wide(p), x.double(), rand)))
    arms["port float64, G's images rounded to fp32"] = run(
        torch.float64, lambda p, n, rand, noise=None: port_gen(p, n, rand, noise=noise).float().double())
    error = images[torch.float32].double() - images[torch.float64]
    for share in (1.0, 0.5):
        arms[f"port float64, G's images + {share} x the fp32 G's error"] = run(
            torch.float64, lambda p, n, rand, noise=None: port_gen(p, n, rand, noise=noise) + share * error)
    for seed in NOISE_SEEDS:
        shift = 1e-6 * torch.randn(error.shape, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
        arms[f"port float64, G's images + 1e-6 N(0, 1), seed {seed}"] = run(
            torch.float64, lambda p, n, rand, noise=None: port_gen(p, n, rand, noise=noise) + shift)
    z = draws.noises[-1]  # the critic substep's

    def jax_images(p, z):
        with apply_context(p):
            return jax_gen(z.shape[0], z)

    jax_error = torch.from_numpy(np.asarray(jax.jit(jax_images)(dict(after_g.gen_params), jnp.asarray(z)),
                                            np.float64)) - images[torch.float64]
    for name, e in (("port's", error), ("JAX package's jitted", jax_error)):
        print(f"step {step}: the {name} fp32 G's images lie {float(e.abs().max()):.3g} (max), "
              f"{float(e.pow(2).mean().sqrt()):.3g} (RMS) from the port's float64 G's")
    gap = lambda metrics, k: abs(metrics[k] - ref[k]) / abs(ref[k])
    return {name: (gap(m, "disc_cost"), gap(m, "gp"), _grad_dev(g, ref_grads)) for name, (m, g) in arms.items()}


if __name__ == "__main__":
    for step in (0, 1):
        for name, (cost, gp, grads) in probe(step).items():
            print(f"resnet101 {MODE} step {step}, {name}: disc_cost off by {cost:.3g} of its value, gp by "
                  f"{gp:.3g}, gradients by {grads:.3g} of a tensor's scale")
    for name, (cost, grads) in probe_gen(1).items():
        print(f"resnet101 {MODE} step 1, G substep, {name}: gen_cost off by {cost:.3g} of its value, G's gradients "
              f"by {grads:.3g} of a tensor's scale")
