"""The measurements behind the 64 px tests' tolerances, on the CPU:

    python tests/torch_precision_probe.py

1. bf16 G (dim 8, batch 4, seeds 1-8): the port's bf16 output against the
   JAX package's bf16 and against the port's fp32, each as a multiple of
   U = 2**-8 of the largest magnitude (tests/test_torch_good64.py's 24 U).
2. The wgan-gp critic loss at dim 8 (batch norm in D) and its parameter
   gradients, in fp32: the port with its two-pass CPU batch norm, the port
   with PyTorch's ``F.batch_norm`` CPU kernel, and the JAX package, each
   against the port in float64 (``ctgan_tpu_torch/ops/norm.py``).
3. The wgan-ct critic's gradients at step 1 (after one jitted JAX
   iteration): the JAX package's fp32 and the port's fp32 against the port
   in float64 (tests/test_torch_gan_trainer.py's ``GRAD_RTOL``).
4. The inception score of ``runs/good64_r5/params_latest.npz`` by the port
   on the CPU, on the noise, batches and scorer of ``chip_smoke.py``'s
   good64_checkpoint phase, beside the JAX package's (its ``GOOD64_IS_REF``).

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

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from ctgan_tpu.core import default_tpu_policy  # noqa: E402
from ctgan_tpu.train import GanConfig as JaxGanConfig  # noqa: E402
from ctgan_tpu.train import make_gan_trainer  # noqa: E402
from ctgan_tpu_torch.bridge import to_jax_params  # noqa: E402
from ctgan_tpu_torch.core import precision_policy  # noqa: E402
from ctgan_tpu_torch.models import good64 as port_good64  # noqa: E402
from ctgan_tpu_torch.train import GanConfig, GanTrainer  # noqa: E402

import test_torch_gan_trainer as trainer_tests  # noqa: E402
import test_torch_good64 as model_tests  # noqa: E402
from torch_parity import JaxDraws  # noqa: E402

U = 2.0 ** -8
DIM, BATCH = 8, 4


class _Patch:
    """``monkeypatch.setattr`` for a script: the patches stay."""

    def setattr(self, obj, name, value):
        setattr(obj, name, value)


def bf16_generator() -> None:
    rng = np.random.default_rng(3)
    rng.uniform(-1, 1, size=(BATCH, 3 * 64 * 64))
    noise = rng.normal(size=(BATCH, 128)).astype(np.float32)
    for seed in range(1, 9):
        gen, _ = model_tests.jax_params(DIM, "wgan-ct", seed=seed)
        default_tpu_policy(True)
        want = model_tests._jax_generator(gen, noise)
        default_tpu_policy(False)
        run = lambda: port_good64.generator(model_tests._port(gen), BATCH, None, dim=DIM,
                                            noise=torch.from_numpy(noise))
        with precision_policy("bfloat16"):
            got = run()
        print(f"bf16 G, seed {seed}: port - JAX {model_tests._max_dev(got, want) / U:.2f} U, "
              f"port bf16 - fp32 {model_tests._max_dev(got, run()) / U:.2f} U")


@contextlib.contextmanager
def _pytorch_batch_norm():
    """The 64 px model's batch norms through ``F.batch_norm`` on any device."""
    original = port_good64.batchnorm

    def batchnorm(x, scale, offset):
        wide = x.to(torch.promote_types(x.dtype, torch.float32))
        return F.batch_norm(wide, None, None, weight=scale, bias=offset, training=True, eps=1e-5).to(x.dtype)

    port_good64.batchnorm = batchnorm
    try:
        yield
    finally:
        port_good64.batchnorm = original


def _port_critic(trainer: GanTrainer, state, real, draws, dtype):
    """The port's critic loss and parameter gradients in ``dtype`` on the
    JAX side's draws of one G substep and one critic substep."""
    rand = draws.injected()

    class Cast:
        def __getattr__(self, name):
            return getattr(rand, name)

        def noise(self, n, d):
            return rand.noise(n, d).to(dtype)

        def gp_alpha(self, n):
            return rand.gp_alpha(n).to(dtype)

        def dropout_mask(self, shape, kp, _dtype, device):
            return rand.dropout_mask(shape, kp, dtype, device)

    cast = lambda p: {k: v.detach().to(dtype).requires_grad_(True) for k, v in p.items()}
    with torch.no_grad():
        trainer.gen_loss(cast(state.gen_params), cast(state.disc_params), Cast())
    disc = cast(state.disc_params)
    cost, metrics = trainer.disc_loss(disc, cast(state.gen_params), torch.from_numpy(real).to(dtype), Cast())
    grads = torch.autograd.grad(cost, list(disc.values()))
    return {k: float(v.detach()) for k, v in metrics.items()}, to_jax_params(dict(zip(disc, grads)))


def _grad_dev(got: dict, want: dict) -> float:
    """Largest deviation over each tensor's largest, floored at 1% of the
    largest anywhere (``assert_grads_close``'s scale)."""
    top = max(float(np.abs(v).max()) for v in want.values())
    return max(float(np.abs(np.asarray(got[k], np.float64) - want[k]).max())
               / max(float(np.abs(want[k]).max()), 1e-2 * top) for k in want)


def critic_precision(mode: str, step: int) -> None:
    """At ``step`` (0: the initial state; 1: after one JAX iteration) the
    critic's gradient penalty and gradients of the port in fp32 (and, for
    batch norm, with PyTorch's kernel) and of the JAX package, against the
    port in float64."""
    gen, disc = trainer_tests._jax_arrays(DIM, mode, seed=5)
    draws = JaxDraws(_Patch(), model=trainer_tests.jax_good64)
    (jax_gen, jax_disc), (port_gen, port_disc) = trainer_tests._models(mode)
    init_state, step_fn, _, _ = make_gan_trainer(jax_gen, jax_disc,
                                                 JaxGanConfig(mode=mode, batch_size=BATCH, critic_iters=1))
    trainer = GanTrainer(port_gen, port_disc, GanConfig(mode=mode, batch_size=BATCH, critic_iters=1))
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
    ref, ref_grads = _port_critic(trainer, port_state, real[0], draws, torch.float64)
    arms = {"port fp32": _port_critic(trainer, port_state, real[0], draws, torch.float32),
            "JAX fp32": ({k: float(v) for k, v in jax_metrics.items()}, jax_grads)}
    if mode != "wgan-ct":
        with _pytorch_batch_norm():
            arms["port fp32, F.batch_norm"] = _port_critic(trainer, port_state, real[0], draws, torch.float32)
    for name, (metrics, grads) in arms.items():
        print(f"{mode} step {step}, {name} against the port in float64: gp off by "
              f"{abs(metrics['gp'] - ref['gp']) / ref['gp']:.3g} of its value, gradients by "
              f"{_grad_dev(grads, ref_grads):.3g} of a tensor's scale")


def checkpoint_inception_score() -> None:
    from ctgan_tpu_torch.bridge import from_jax_params
    from ctgan_tpu_torch.data import synthetic_images
    from ctgan_tpu_torch.eval import TrainedScorer
    from ctgan_tpu_torch.utils import load_checkpoint

    blob = load_checkpoint(str(model_tests.JAX_PARAMS))
    gen = from_jax_params(blob["params"]["gen_params"])
    noise = np.random.default_rng(0).standard_normal((1000, 128), dtype=np.float32)
    with torch.no_grad():
        flat = torch.cat([port_good64.generator(gen, 100, None, noise=torch.from_numpy(noise[i:i + 100]))
                          for i in range(0, 1000, 100)])
    images = ((flat + 1.0) * (255.0 / 2)).to(torch.int32)
    scorer = TrainedScorer(3, 64, cache_path=str(model_tests.JAX_PARAMS.parent / "scorer.npz"), device="cpu")
    real = synthetic_images(4096, 3, 64, seed=0)[0][:1000]
    jax_is, jax_fid = model_tests.jax_checkpoint_scores()
    print(f"good64_r5 on the CPU: port IS {scorer.inception_score(images)[0]!r}, FID "
          f"{scorer.fid(real, images)!r}; JAX IS {jax_is!r}, FID {jax_fid!r}")


if __name__ == "__main__":
    bf16_generator()
    critic_precision("wgan-gp", 0)
    critic_precision("wgan-ct", 1)
    checkpoint_inception_score()
