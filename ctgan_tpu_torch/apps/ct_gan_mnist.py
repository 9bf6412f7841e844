"""CT-GAN on MNIST, the paper's first conv model (counterpart of
``ctgan_tpu/apps/ct_gan_mnist.py``; ``CT_gan_mnist.py``).

    python -m ctgan_tpu_torch.apps.ct_gan_mnist --ITERS 15 --out_dir runs/x

The flags are the fields of :class:`Config`, under the JAX app's names and
defaults: ``MODE`` wgan-CT (or wgan, dcgan), ``DIM`` 64, batch 50, 5
critic iterations (1 in dcgan), the first 1,000 training images, 50,000
iterations.  ``CUDA_DROPOUT`` takes the place of ``PALLAS_DROPOUT`` and,
like it, is on by default.  ``BF16`` sets the bf16 policy
(``core.precision``) when the run is on the card; on the CPU the run is
fp32, as the JAX app is off the accelerator; ``--BF16 0`` runs fp32 on the
card too.

Data: ``data.mnist`` (the file where the JAX package would read it, else
its synthetic set), flat ``[N, 784]`` in [0, 1], on the device; each
iteration takes its ``[K, B]`` batch with ``DeviceSampler`` at the state's
step.  G (``models.dcgan.mnist_generator``) ends in a sigmoid, so reals
and fakes share [0, 1].  D drops out after each of its three convs at keep
0.5 through the CUDA mask kernel: a 1G+5D wgan-CT iteration launches it 63
times, 21 at each of ``[B, 64, 14, 14]``, ``[B, 128, 7, 7]`` and ``[B,
256, 4, 4]`` (dim 64).

The run is the JAX app's workflow through ``train.loop.train_loop``
(``apps.common.run_gan_loop``): metrics printed on the first 5 iterations
and every 100th; every ``sample_every`` iterations ``dev disc cost``, the
critic's cost over the first ``BATCH_SIZE * 10`` dev images in batches of
``BATCH_SIZE`` (batch ``i`` draws from seed ``i``), and a grid of 128
samples of fixed noise (``samples_<it>.png``); every ``save_every`` a
checkpoint in the JAX package's format and ``params_latest.npz``.  Run it
again with the same ``out_dir`` and it resumes, also from a checkpoint the
JAX app wrote.  Every iteration's draws are a function of ``(seed, step)``.

Entry points run on ``cuda``; ``main(..., device="cpu")`` runs on the CPU
with the dropout kernel's plain version.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..bridge import from_jax_params
from ..core import Randomness, default_policy, split_params
from ..data import DeviceSampler, mnist
from ..models import dcgan
from ..train import GanConfig, GanState, GanTrainer
from . import common
from .common import gan_batches, require_device, run_gan_loop, save_sample_grid, setup_out_dir

__all__ = ["Config", "GanApp", "main", "make_step_fn", "make_test_fn", "parse_config", "setup"]

CHW = (1, 28, 28)
N_GRID = 128


@dataclass(frozen=True)
class Config:
    MODE: str = "wgan-CT"
    DIM: int = 64
    BATCH_SIZE: int = 50
    CRITIC_ITERS: int = 5
    LAMBDA: float = 10.0
    LAMBDA_2: float = 2.0
    Factor_M: float = 0.0
    ITERS: int = 50000
    n_examples: int = 1000
    seed: int = 0
    allow_fresh_start: bool = False
    out_dir: str = "runs/ct_gan_mnist"
    save_every: int = 1000
    sample_every: int = 100
    BF16: bool = True
    CUDA_DROPOUT: bool = True


def parse_config(argv=None) -> Config:
    return common.parse_config(Config, argv)


class GanApp(NamedTuple):
    """What a run of the MNIST or the CIFAR-10 app holds."""

    trainer: GanTrainer
    state: GanState
    sampler: DeviceSampler
    rand: Randomness
    dev: torch.Tensor  # the dev cost's images, on the device


def build(cfg, arch: str, gen_fn, disc_fn, train_images: np.ndarray, dev_images: np.ndarray,
          device) -> GanApp:
    """A fresh ``GanApp`` of ``arch`` (``dcgan.init_params``) on ``device``;
    sets the process-wide precision policy: bf16 where ``cfg.BF16`` and the
    device is CUDA, else fp32."""
    device = torch.device(device)
    default_policy(enable_bf16=cfg.BF16 and device.type == "cuda")
    params = dcgan.init_params(arch, cfg.DIM, cfg.MODE, cfg.seed)
    tensors = {k: v.to(device) for k, v in from_jax_params(params).items()}
    gparams, dparams, rest = split_params(tensors, "Generator", "Discriminator")
    if rest:
        raise RuntimeError(f"parameters outside G and D: {sorted(rest)}")
    trainer = GanTrainer(gen_fn, disc_fn, GanConfig(
        mode=cfg.MODE, batch_size=cfg.BATCH_SIZE, critic_iters=cfg.CRITIC_ITERS, lambda_gp=cfg.LAMBDA,
        lambda_ct=cfg.LAMBDA_2, factor_m=cfg.Factor_M, iters=cfg.ITERS,
    ))
    critic_iters = 1 if cfg.MODE == "dcgan" else cfg.CRITIC_ITERS
    sampler = DeviceSampler([train_images], cfg.BATCH_SIZE, critic_iters, seed=cfg.seed, device=device)
    rand = Randomness(cfg.seed, device, cuda_dropout=cfg.CUDA_DROPOUT)
    dev = torch.from_numpy(dev_images[: cfg.BATCH_SIZE * 10]).to(device)
    return GanApp(trainer, trainer.init_state(gparams, dparams), sampler, rand, dev)


def setup(cfg: Config, device) -> GanApp:
    """Fresh trainer and state, the data on the device, and the base
    randomness of a run of ``cfg`` on ``device``."""

    def gen_fn(p, n, rand, noise=None):
        return dcgan.mnist_generator(p, n, rand, dim=cfg.DIM, mode=cfg.MODE, noise=noise)

    def disc_fn(p, x, rand):
        return dcgan.mnist_discriminator(p, x, rand, dim=cfg.DIM, mode=cfg.MODE)

    data = mnist.load_arrays(n_examples=cfg.n_examples)
    return build(cfg, "mnist", gen_fn, disc_fn, data["train"][0], data["dev"][0], device)


def make_step_fn(app: GanApp, to_real=None):
    """``step_fn(state, idx, rand)`` for the train loop: the batch at the
    iteration's ``K * B`` pool indices ``idx`` (``common.gan_batches``),
    gathered on the device (through ``to_real``, if given), then one
    iteration, every draw from ``rand.for_step(state.step)``."""

    def step_fn(state: GanState, idx: torch.Tensor, rand: Randomness):
        real = app.sampler.gather(idx)
        return state, app.trainer.step(state, real if to_real is None else to_real(real),
                                       rand.for_step(state.step))

    return step_fn


def dev_cost(cfg, app: GanApp, state: GanState, to_real=None) -> float:
    """The mean of the critic's cost over the dev images in batches of
    ``BATCH_SIZE``, batch ``i`` (from image ``i``) drawing from seed ``i``,
    as the JAX apps draw from ``PRNGKey(i)``."""
    costs = []
    for i in range(0, len(app.dev), cfg.BATCH_SIZE):
        real = app.dev[i:i + cfg.BATCH_SIZE]
        real = real if to_real is None else to_real(real)
        rand = Randomness(i, app.rand.device, cuda_dropout=cfg.CUDA_DROPOUT)
        costs.append(app.trainer.dev_cost(state, real, rand))
    return float(torch.stack(costs).mean())


def fixed_noise(cfg, device) -> torch.Tensor:
    """The grid's noise: ``default_rng(seed)`` normals, ``[128, 128]``."""
    noise = np.random.default_rng(cfg.seed).normal(size=(N_GRID, 128)).astype("f4")
    return torch.from_numpy(noise).to(device)


def make_test_fn(cfg: Config, app: GanApp, out_dir: str):
    """The JAX app's ``test_fn(state, iteration) -> metrics``: ``dev disc
    cost`` and the grid of 128 samples of fixed noise in [0, 1]."""
    noise = fixed_noise(cfg, app.rand.device)

    def test_fn(state: GanState, iteration: int) -> dict:
        metrics = {"dev disc cost": dev_cost(cfg, app, state)}
        save_sample_grid(app.trainer.sample(state, noise, None), CHW, f"{out_dir}/samples_{iteration}.png",
                         value_range=(0.0, 1.0))
        return metrics

    return test_fn


def main(argv=None, cfg: Config | None = None, device="cuda"):
    """Train to ``cfg.ITERS`` iterations on ``device``, resuming from
    ``out_dir`` when it holds a checkpoint.  Returns the final state and
    the records printed by this process."""
    cfg = cfg or parse_config(argv)
    device = require_device(device)
    out_dir = setup_out_dir(cfg)
    app = setup(cfg, device)
    print(f"device {device}, out_dir {out_dir}")
    return run_gan_loop(cfg, app.state, make_step_fn(app), gan_batches(app), app.rand,
                        make_test_fn(cfg, app, out_dir), out_dir, device)


if __name__ == "__main__":
    main()
