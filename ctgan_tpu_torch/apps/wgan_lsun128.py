"""128x128 ResNet WGAN-GP + CT, the LSUN bedrooms model (counterpart of
``ctgan_tpu/apps/wgan_lsun128.py``).

    python -m ctgan_tpu_torch.apps.wgan_lsun128 --ITERS 20 --out_dir runs/l

The flags are the fields of :class:`Config`, under the JAX app's names and
defaults (``ctgan_tpu/apps/wgan_lsun128.py:26-57``): batch 64, 5 critic
iterations, ``LAMBDA_2`` 2.0 (the GP's weight is the trainer's 10), Adam at
1e-4 with ``beta1`` 0 and linear decay to ``ITERS``, ``DIM_G_4`` and
``DIM_D_8`` 1024 (``models.lsun128``), ``BF16`` on, ``FUSE_MEANPOOL`` off.
``CUDA_DROPOUT`` takes the place of ``PALLAS_DROPOUT`` and, like it, is on
by default: D's three masks per pass, ``[64, 1024, 8, 8]`` each, come from
the CUDA kernel, 63 per iteration.  Not ported yet, and refused: ``REMAT``
and a non-fp32 ``OPT_STATE_DTYPE`` (ROADMAP Queue 1 item 17).

Precision as in the other GAN apps: ``BF16`` sets the bf16 policy
(``core.precision``) process-wide when the run is on the card; on the CPU
the run is fp32; ``--BF16 0`` runs fp32 on the card too.

Data, as the JAX app chooses it: ``input hbm`` (the default) without
``DATA_DIR`` takes each iteration's ``[K, B]`` batch of the synthetic pool
of 2,048 128 px images (seed ``seed``, uint8 on the device) with
``DeviceSampler``, scaled by ``2 * (x / 255 - 0.5)`` and flipped at random
(``data.augment``); otherwise (``DATA_DIR``, ``input dir``) the image
directory (``data.images_dir``: PIL, a background thread), or its synthetic
fallback of 4,096 images when ``DATA_DIR`` is empty or missing.

The run is the JAX app's workflow through ``train.loop.train_loop``:
metrics printed with their spread on the first 5 iterations and every
100th; every ``sample_every`` iterations a grid of 64 samples of fixed
noise (``samples_<it>.png``, 128 px); every ``save_every`` iterations a
checkpoint ``ckpt/ckpt_<N>.npz`` in the JAX package's format and
``params_latest.npz``.  Run it again with the same ``out_dir`` and it
resumes, also from a checkpoint the JAX app wrote.  No inception score, as
in the JAX app.

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
from ..data import DeviceSampler, synthetic_images
from ..models import lsun128
from ..train import GanConfig, GanState, GanTrainer
from . import common
from .common import HostFeed, dir_feed, gan_step_fn, require_device, run_gan_loop, save_sample_grid, setup_out_dir

__all__ = ["AppLsun", "Config", "check_supported", "main", "make_step_fn", "make_test_fn", "model_config",
           "parse_config", "setup"]

SIZE = 128
CHW = (3, SIZE, SIZE)
N_POOL = 2048
N_GRID = 64


@dataclass(frozen=True)
class Config:
    BATCH_SIZE: int = 64
    CRITIC_ITERS: int = 5
    ITERS: int = 200000
    LAMBDA_2: float = 2.0
    Factor_M: float = 0.0
    LR: float = 1e-4
    DECAY: bool = True
    DIM_G_4: int = 1024
    DIM_D_8: int = 1024
    DATA_DIR: str = ""
    OPT_STATE_DTYPE: str = "float32"
    REMAT: bool = False
    input: str = "hbm"
    BF16: bool = True
    CUDA_DROPOUT: bool = True
    FUSE_MEANPOOL: bool = False
    seed: int = 0
    allow_fresh_start: bool = False
    out_dir: str = "runs/wgan_lsun128"
    sample_every: int = 200
    save_every: int = 1000


def parse_config(argv=None) -> Config:
    return common.parse_config(Config, argv)


def check_supported(cfg: Config) -> None:
    if cfg.input not in ("hbm", "dir"):
        raise ValueError(f"unknown input {cfg.input!r} (one of ('hbm', 'dir'))")
    if cfg.REMAT or cfg.OPT_STATE_DTYPE != "float32":
        raise NotImplementedError("REMAT and OPT_STATE_DTYPE are not ported yet: ROADMAP Queue 1 item 17")


def model_config(cfg: Config) -> lsun128.Lsun128Config:
    """The model of ``cfg``: the default widths but ``dim_g_4`` and
    ``dim_d_8``, as the JAX app builds it."""
    return lsun128.Lsun128Config(dim_g_4=cfg.DIM_G_4, dim_d_8=cfg.DIM_D_8)


class AppLsun(NamedTuple):
    trainer: GanTrainer
    state: GanState
    sampler: DeviceSampler | None  # the hbm path's
    rand: Randomness
    feed: HostFeed | None  # the directory path's


def setup(cfg: Config, device, pool: np.ndarray | None = None) -> AppLsun:
    """Fresh trainer and state, the input path (``pool``: the hbm path's
    flat uint8 images in place of the synthetic 2,048) and the base
    randomness of a run of ``cfg`` on ``device``.  Sets the process-wide
    precision policy: bf16 where ``cfg.BF16`` and the device is CUDA, else
    fp32."""
    check_supported(cfg)
    device = torch.device(device)
    default_policy(enable_bf16=cfg.BF16 and device.type == "cuda")
    mcfg = model_config(cfg)
    gen_fn = lambda p, n, rand, noise=None: lsun128.generator(p, n, rand, cfg=mcfg, noise=noise)
    disc_fn = lambda p, x, rand: lsun128.discriminator(p, x, rand, cfg=mcfg, fuse_meanpool=cfg.FUSE_MEANPOOL)
    gcfg = GanConfig(
        mode="wgan-CT", batch_size=cfg.BATCH_SIZE, critic_iters=cfg.CRITIC_ITERS, lambda_ct=cfg.LAMBDA_2,
        factor_m=cfg.Factor_M, lr=cfg.LR, lr_decay=cfg.DECAY, iters=cfg.ITERS, beta1=0.0,
    )
    tensors = {k: v.to(device) for k, v in from_jax_params(lsun128.init_params(mcfg, cfg.seed)).items()}
    gparams, dparams, rest = split_params(tensors, "Generator", "Discriminator")
    if rest:
        raise RuntimeError(f"parameters outside G and D: {sorted(rest)}")
    trainer = GanTrainer(gen_fn, disc_fn, gcfg)
    sampler = feed = None
    if not cfg.DATA_DIR and cfg.input == "hbm":
        flat = pool if pool is not None else synthetic_images(N_POOL, 3, SIZE, seed=cfg.seed)[0]
        sampler = DeviceSampler([flat], cfg.BATCH_SIZE, cfg.CRITIC_ITERS, seed=cfg.seed, device=device)
    else:
        feed = dir_feed(cfg.DATA_DIR, cfg.BATCH_SIZE, cfg.CRITIC_ITERS, SIZE, cfg.seed, device)
    rand = Randomness(cfg.seed, device, cuda_dropout=cfg.CUDA_DROPOUT)
    return AppLsun(trainer, trainer.init_state(gparams, dparams), sampler, rand, feed)


def make_step_fn(app: AppLsun):
    """``common.gan_step_fn`` at this app's image shape."""
    return gan_step_fn(app, CHW)


def make_test_fn(cfg: Config, app: AppLsun, out_dir: str):
    """The JAX app's ``test_fn``: a grid of 64 samples of the fixed noise
    ``default_rng(seed).normal((64, 128))``."""
    trainer, device = app.trainer, app.rand.device
    fixed_noise = torch.from_numpy(
        np.random.default_rng(cfg.seed).normal(size=(N_GRID, 128)).astype("f4")).to(device)

    def test_fn(state: GanState, iteration: int) -> dict:
        save_sample_grid(trainer.sample(state, fixed_noise, None), CHW, f"{out_dir}/samples_{iteration}.png")
        return {}

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
    try:
        return run_gan_loop(cfg, app.state, make_step_fn(app), app.rand, make_test_fn(cfg, app, out_dir),
                            out_dir, device, print_std=True)
    finally:
        if app.feed is not None:
            app.feed.close()


if __name__ == "__main__":
    main()
