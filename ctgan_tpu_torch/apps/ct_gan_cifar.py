"""CT-GAN on CIFAR-10 with the paper's conv G and D (counterpart of
``ctgan_tpu/apps/ct_gan_cifar.py``; ``CT_gan_cifar.py``).

    python -m ctgan_tpu_torch.apps.ct_gan_cifar --ITERS 15 --out_dir runs/x

The flags are the fields of :class:`Config`, under the JAX app's names and
defaults: ``MODE`` wgan-CT, ``DIM`` 128, batch 64, 5 critic iterations,
the first 1,000 training images, inception score every 1,000 iterations
on 1,000 samples.  ``CUDA_DROPOUT`` takes the place of ``PALLAS_DROPOUT``;
``BF16`` as in the MNIST app (bf16 on the card, fp32 on the CPU).

Data: ``data.cifar10`` (batch files in ``DATA_DIR``, else the synthetic
set), uint8 on the device; each iteration's ``[K, B]`` batch is scaled to
``2 * (x / 255 - 0.5)``, with no dequantisation noise, as the JAX app does
(so ``philox_uniform`` is not on this path).  D drops out after each conv
at keep 0.5 through the CUDA mask kernel: 63 launches per wgan-CT
iteration, 21 at each of ``[B, 128, 16, 16]``, ``[B, 256, 8, 8]`` and
``[B, 512, 4, 4]`` (dim 128).  D has batch norm unless ``MODE`` is exactly
``wgan-CT``.

The run is the JAX app's workflow: every ``sample_every`` iterations the
dev cost (``dev disc cost``, over the first ``BATCH_SIZE * 10`` test images
in batches of ``BATCH_SIZE``, batch ``i`` from seed ``i``), ``slope_real``
(the largest ``|dD(x)/dx|_2`` over the first dev batch, dropout drawn from
seed 0), D's parameters dumped to ``disc_params.npz`` in the JAX layout,
and a grid of 128 fixed samples, ``samples_<it>.png`` (the JAX app writes
a JPEG under the same stem; the port writes PNG only); every
``inception_every`` iterations ``inception score`` over
``inception_samples`` images made in batches of 100 from the noise of seed
``1000 + i``, through ``common.pick_scorer``'s scorer: Inception-2015 when a
weight file is found, else the TrainedScorer cached in ``<out_dir>/scorer.npz``
(fitted on the whole training split when missing); checkpoints and resume
as in the MNIST app.

Entry points run on ``cuda``; ``main(..., device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..bridge import to_jax_params
from ..core import Randomness
from ..data import load_arrays
from ..losses import input_slopes
from ..models import dcgan
from ..train import GanState
from ..utils import save_checkpoint
from . import common
from .common import gan_batches, pick_scorer, require_device, run_gan_loop, save_sample_grid, setup_out_dir
from .ct_gan_mnist import GanApp, build, dev_cost, fixed_noise, make_step_fn

__all__ = ["Config", "generate_images", "main", "make_test_fn", "parse_config", "setup", "to_real"]

CHW = (3, 32, 32)
GEN_CHUNK = 100  # images per generator call in the IS eval (batch statistics!)


@dataclass(frozen=True)
class Config:
    MODE: str = "wgan-CT"
    DIM: int = 128
    BATCH_SIZE: int = 64
    CRITIC_ITERS: int = 5
    LAMBDA: float = 10.0
    LAMBDA_2: float = 2.0
    Factor_M: float = 0.0
    ITERS: int = 50000
    n_examples: int = 1000
    DATA_DIR: str = ""
    seed: int = 0
    allow_fresh_start: bool = False
    out_dir: str = "runs/ct_gan_cifar"
    inception_every: int = 1000
    inception_samples: int = 1000
    sample_every: int = 100
    save_every: int = 1000
    BF16: bool = True
    CUDA_DROPOUT: bool = True


def parse_config(argv=None) -> Config:
    return common.parse_config(Config, argv)


def to_real(raw: torch.Tensor) -> torch.Tensor:
    """uint8 images -> fp32 reals ``2 * (x / 255 - 0.5)``."""
    return 2.0 * (raw.float() / 255.0 - 0.5)


def setup(cfg: Config, device) -> GanApp:
    """Fresh trainer and state, the data on the device, and the base
    randomness of a run of ``cfg`` on ``device``."""

    def gen_fn(p, n, rand, noise=None):
        return dcgan.cifar_generator(p, n, rand, dim=cfg.DIM, noise=noise)

    def disc_fn(p, x, rand):
        return dcgan.cifar_discriminator(p, x, rand, dim=cfg.DIM, mode=cfg.MODE)

    data = load_arrays(cfg.DATA_DIR or None, n_examples=cfg.n_examples)
    return build(cfg, "cifar", gen_fn, disc_fn, data["train"][0], data["test"][0], device)


def generate_images(app: GanApp, state: GanState, n: int) -> torch.Tensor:
    """``n`` images as the JAX app generates them for the IS: batches of
    100 from the noise of seed ``1000 + i``, values ``int32((x + 1) * 255 /
    2)``."""
    device = app.rand.device
    outs = [app.trainer.sample(state, Randomness(1000 + i, device).noise(GEN_CHUNK, 128), None)
            for i in range(0, n, GEN_CHUNK)]
    return ((torch.cat(outs)[:n].float() + 1.0) * (255.0 / 2)).to(torch.int32)


def make_test_fn(cfg: Config, app: GanApp, scorer, out_dir: str):
    """The JAX app's ``test_fn(state, iteration) -> metrics``."""
    noise = fixed_noise(cfg, app.rand.device)
    first = to_real(app.dev[: cfg.BATCH_SIZE])

    def test_fn(state: GanState, iteration: int) -> dict:
        metrics = {"dev disc cost": dev_cost(cfg, app, state, to_real)}
        disc = {k: v.detach() for k, v in state.disc_params.items()}
        rand = Randomness(0, app.rand.device, cuda_dropout=cfg.CUDA_DROPOUT)
        slopes = input_slopes(lambda x: app.trainer.disc_fn(disc, x, rand)[0], first)
        metrics["slope_real"] = float(slopes.max())
        save_checkpoint(f"{out_dir}/disc_params.npz", to_jax_params(state.disc_params))
        save_sample_grid(app.trainer.sample(state, noise, None), CHW, f"{out_dir}/samples_{iteration}.png")
        if scorer is not None and iteration % cfg.inception_every == cfg.inception_every - 1:
            metrics["inception score"] = scorer.inception_score(
                generate_images(app, state, cfg.inception_samples))[0]
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
    scorer = None
    if cfg.inception_every:
        full = load_arrays(cfg.DATA_DIR or None)
        scorer = pick_scorer(3, 32, out_dir, train_data=full["train"], device=device)
        if not scorer.comparable:
            print("scorer test acc:", scorer.sanity_check(full["test"][0][:2000], full["test"][1][:2000]))
    return run_gan_loop(cfg, app.state, make_step_fn(app, to_real), gan_batches(app), app.rand,
                        make_test_fn(cfg, app, scorer, out_dir), out_dir, device)


if __name__ == "__main__":
    main()
