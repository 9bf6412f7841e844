"""64x64 CT-GAN (counterpart of ``ctgan_tpu/apps/ct_gan_64x64.py``).

    python -m ctgan_tpu_torch.apps.ct_gan_64x64 --ITERS 15 --out_dir runs/x

The flags are the fields of :class:`Config`, under the JAX app's names and
defaults (``ctgan_tpu/apps/ct_gan_64x64.py:29-63``): ``MODE`` wgan-ct,
``ARCH`` good, ``DIM`` 64, batch 64, 5 critic iterations, ``BF16`` and
``FUSE_MEANPOOL`` on.  ``CUDA_DROPOUT`` takes the place of
``PALLAS_DROPOUT`` and, like it, is on by default.

``ARCH`` picks G and D as the JAX app's menu does
(``ctgan_tpu/apps/ct_gan_64x64.py:67-99``): ``good`` (the "Good" ResNet,
``models.good64``), ``dcgan`` (DCGAN G and D, built under a 0.02 init
stdev), ``crippled`` (the WGAN paper's G without batch norm, DCGAN D),
``fc`` (the fully-connected G, ``models.fc``, DCGAN D),
``multiplicative`` (gated G and D; ``models.dcgan``) and ``resnet101``
(the 101-layer bottleneck ResNet, ``models.good64``, layer norm in D
whatever the mode).  Only ``good``'s D drops out: the other archs launch no
kernel.  Not ported yet, and refused: ``REMAT`` and a non-fp32
``OPT_STATE_DTYPE`` (ROADMAP Queue 1 item 17).

Precision as in the flagship app: ``BF16`` sets the bf16 policy
(``core.precision``) process-wide when the run is on the card; on the CPU
the run is fp32, as the JAX app is off the accelerator; ``--BF16 0`` runs
fp32 on the card too.

Data, as the JAX app chooses it (``ctgan_tpu/apps/ct_gan_64x64.py:139-180``):

* ``input hbm`` (the default) without ``DATA_DIR``: the synthetic pool of
  4,096 64 px images (seed ``seed``), uint8 on the device.  Each iteration
  takes its ``[K, B]`` batch from the pool with ``DeviceSampler`` at the
  state's step, scales it by ``2 * (x / 255 - 0.5)`` and flips each image
  left to right with probability 1/2 (``data.augment``, the math of
  ``ctgan_tpu/data/hbm_input.py:68-74``); no dequantisation noise.
* ``input native`` without ``DATA_DIR``: the same pool through the native
  host pipeline (``data.native.NativePipeline``: shuffle, flips and scaling
  in C++ worker threads), when its library builds; else the next path.
* otherwise (``DATA_DIR``, ``input dir``): the image directory
  (``data.images_dir``, PIL), or its synthetic fallback when ``DATA_DIR``
  is empty or missing, decoded in a background thread.  There is no pool to
  fit a scorer on or take FID against: IS needs a ``scorer.npz`` in
  ``out_dir``, else it is off, as in the JAX app.

``dcgan`` trains one critic batch per iteration.

The run is the JAX app's workflow through ``train.loop.train_loop``:
metrics printed on the first 5 iterations and every 100th; every
``sample_every`` iterations a grid of 64 samples of fixed noise
(``samples_<it>.png``); every ``inception_every`` iterations the inception
score over ``inception_samples`` images generated in batches of 100 and FID
against as many pool images, through the TrainedScorer cached in
``<out_dir>/scorer.npz`` (fitted on the pool when missing); every
``save_every`` iterations a checkpoint ``ckpt/ckpt_<N>.npz`` in the JAX
package's format, with the sampler's position as ``data_state``, and
``params_latest.npz``.  Run it again with the same ``out_dir`` and it
resumes, also from a checkpoint the JAX app wrote.  Every iteration's draws
are a function of ``(seed, step)``.

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
from ..data.native import NativePipeline, native_available
from ..models import dcgan, fc, good64
from ..train import GanConfig, GanState, GanTrainer
from . import common
from .common import (
    HostFeed,
    dir_feed,
    gan_step_fn,
    native_feed,
    pick_scorer,
    require_device,
    run_gan_loop,
    save_sample_grid,
    setup_out_dir,
)

__all__ = ["App64", "Config", "check_supported", "init_params", "main", "make_step_fn", "make_test_fn", "parse_config",
           "pick_arch", "setup"]

CHW = (3, 64, 64)
N_POOL = 4096
GEN_CHUNK = 100  # images per generator call in the IS/FID eval (batch statistics!)
N_GRID = 64
ARCHS = ("good", "dcgan", "crippled", "fc", "multiplicative", "resnet101")
INPUTS = ("hbm", "native", "dir")


@dataclass(frozen=True)
class Config:
    MODE: str = "wgan-ct"
    ARCH: str = "good"
    REMAT: bool = False
    OPT_STATE_DTYPE: str = "float32"
    BF16: bool = True
    CUDA_DROPOUT: bool = True
    FUSE_MEANPOOL: bool = True
    DIM: int = 64
    BATCH_SIZE: int = 64
    CRITIC_ITERS: int = 5
    LAMBDA: float = 10.0
    LAMBDA_2: float = 2.0
    Factor_M: float = 0.0
    ITERS: int = 200000
    DATA_DIR: str = ""
    seed: int = 0
    allow_fresh_start: bool = False
    out_dir: str = "runs/ct_gan_64x64"
    sample_every: int = 200
    save_every: int = 1000
    inception_every: int = 2000
    inception_samples: int = 1000
    input: str = "hbm"


def parse_config(argv=None) -> Config:
    return common.parse_config(Config, argv)


def check_supported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for what the port lacks, naming its
    ROADMAP item; ``ValueError`` for an unknown ``ARCH`` or ``input``."""
    if cfg.ARCH not in ARCHS:
        raise ValueError(f"unknown ARCH {cfg.ARCH!r}")
    if cfg.input not in INPUTS:
        raise ValueError(f"unknown input {cfg.input!r} (one of {INPUTS})")
    if cfg.REMAT or cfg.OPT_STATE_DTYPE != "float32":
        raise NotImplementedError("REMAT and OPT_STATE_DTYPE are not ported yet: ROADMAP Queue 1 item 17")


def pick_arch(cfg: Config):
    """``(gen_fn(p, n, rand, noise=None), disc_fn(p, x, rand))`` of
    ``cfg.ARCH``."""
    dim, mode = cfg.DIM, cfg.MODE
    gens = {
        "good": lambda p, n, rand, noise=None: good64.generator(p, n, rand, dim=dim, noise=noise),
        "dcgan": lambda p, n, rand, noise=None: dcgan.dcgan64_generator(p, n, rand, dim=dim, noise=noise),
        "crippled": lambda p, n, rand, noise=None: dcgan.crippled_dcgan64_generator(p, n, rand, dim=dim,
                                                                                    noise=noise),
        "fc": lambda p, n, rand, noise=None: fc.fc_generator(p, n, rand, noise=noise),
        "multiplicative": lambda p, n, rand, noise=None: dcgan.multiplicative_dcgan64_generator(
            p, n, rand, dim=dim, noise=noise),
        "resnet101": lambda p, n, rand, noise=None: good64.resnet101_generator(p, n, rand, dim=dim, noise=noise),
    }
    if cfg.ARCH == "resnet101":
        disc = lambda p, x, rand: good64.resnet101_discriminator(p, x, rand, dim=dim)
    elif cfg.ARCH == "good":
        disc = lambda p, x, rand: good64.discriminator(p, x, rand, dim=dim, mode=mode,
                                                       fuse_meanpool=cfg.FUSE_MEANPOOL)
    elif cfg.ARCH == "multiplicative":
        disc = lambda p, x, rand: dcgan.multiplicative_dcgan64_discriminator(p, x, rand, dim=dim, mode=mode)
    else:
        disc = lambda p, x, rand: dcgan.dcgan64_discriminator(p, x, rand, dim=dim, mode=mode)
    return gens[cfg.ARCH], disc


class App64(NamedTuple):
    trainer: GanTrainer
    state: GanState
    sampler: DeviceSampler | None  # the hbm path's
    rand: Randomness
    pool: tuple | None  # (flat uint8 [4096, 12288], labels [4096]) on the host; None on the directory path
    feed: HostFeed | None  # the native and directory paths'


def init_params(cfg: Config) -> dict:
    """Fresh G and D parameters of ``cfg.ARCH`` in the JAX layout."""
    if cfg.ARCH == "good":
        return good64.init_params(cfg.DIM, cfg.MODE, cfg.seed)
    if cfg.ARCH == "resnet101":
        return good64.resnet101_init_params(cfg.DIM, cfg.seed)
    return dcgan.init_params(cfg.ARCH, cfg.DIM, cfg.MODE, cfg.seed)


def setup(cfg: Config, device, pool: tuple | None = None) -> App64:
    """Fresh trainer and state, the input path (see the module's
    docstring; ``pool`` gives the hbm and native paths' ``(flat uint8
    images, labels)`` in place of the synthetic 4,096) and the base
    randomness of a run of ``cfg`` on ``device``.  Sets the process-wide
    precision policy: bf16 where ``cfg.BF16`` and the device is CUDA, else
    fp32."""
    check_supported(cfg)
    device = torch.device(device)
    default_policy(enable_bf16=cfg.BF16 and device.type == "cuda")

    gen_fn, disc_fn = pick_arch(cfg)
    gcfg = GanConfig(
        mode=cfg.MODE, batch_size=cfg.BATCH_SIZE, critic_iters=cfg.CRITIC_ITERS,
        lambda_gp=cfg.LAMBDA, lambda_ct=cfg.LAMBDA_2, factor_m=cfg.Factor_M, iters=cfg.ITERS,
    )
    tensors = {k: v.to(device) for k, v in from_jax_params(init_params(cfg)).items()}
    gparams, dparams, rest = split_params(tensors, "Generator", "Discriminator")
    if rest:
        raise RuntimeError(f"parameters outside G and D: {sorted(rest)}")
    trainer = GanTrainer(gen_fn, disc_fn, gcfg)
    critic_iters = 1 if cfg.MODE == "dcgan" else cfg.CRITIC_ITERS
    sampler = feed = None
    if not cfg.DATA_DIR and cfg.input == "hbm":
        pool = pool or synthetic_images(N_POOL, 3, 64, seed=cfg.seed)
        sampler = DeviceSampler([pool[0]], cfg.BATCH_SIZE, critic_iters, seed=cfg.seed, device=device)
    elif not cfg.DATA_DIR and cfg.input == "native" and native_available():
        pool = pool or synthetic_images(N_POOL, 3, 64, seed=cfg.seed)
        feed = native_feed(NativePipeline(pool[0], None, cfg.BATCH_SIZE, critic_iters, chw=CHW, flip=True,
                                          seed=cfg.seed), device)
    else:
        pool = None
        feed = dir_feed(cfg.DATA_DIR, cfg.BATCH_SIZE, critic_iters, 64, cfg.seed, device)
    rand = Randomness(cfg.seed, device, cuda_dropout=cfg.CUDA_DROPOUT)
    return App64(trainer, trainer.init_state(gparams, dparams), sampler, rand, pool, feed)


def make_step_fn(app: App64):
    """``common.gan_step_fn`` at this app's image shape."""
    return gan_step_fn(app, CHW)


def generate_images(trainer: GanTrainer, state: GanState, n: int, device) -> torch.Tensor:
    """``n`` images as the JAX app generates them for IS/FID: batches of
    100 from the noise of seed ``2000 + i``, values ``int32((x + 1) *
    255 / 2)``."""
    outs = [trainer.sample(state, Randomness(2000 + i, device).noise(GEN_CHUNK, 128), None)
            for i in range(0, n, GEN_CHUNK)]
    return ((torch.cat(outs)[:n].float() + 1.0) * (255.0 / 2)).to(torch.int32)


def make_test_fn(cfg: Config, app: App64, scorer, out_dir: str):
    """The JAX app's ``test_fn(state, iteration) -> metrics``: a grid of 64
    samples of fixed noise and, on the inception cadence, ``inception
    score`` and ``fid``."""
    trainer, device = app.trainer, app.rand.device
    fixed_noise = torch.from_numpy(
        np.random.default_rng(cfg.seed).normal(size=(N_GRID, 128)).astype("f4")).to(device)

    def test_fn(state: GanState, iteration: int) -> dict:
        metrics = {}
        save_sample_grid(trainer.sample(state, fixed_noise, None), CHW,
                         f"{out_dir}/samples_{iteration}.png")
        if scorer is not None and iteration % cfg.inception_every == cfg.inception_every - 1:
            fakes = generate_images(trainer, state, cfg.inception_samples, device)
            metrics["inception score"] = scorer.inception_score(fakes)[0]
            if app.pool is not None:
                metrics["fid"] = float(scorer.fid(app.pool[0][: cfg.inception_samples], fakes))
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
        scorer = pick_scorer(3, 64, out_dir, train_data=app.pool, device=device)
        if scorer.params is None:
            print("IS cadence disabled: no inception file and no labeled data")
            scorer = None
    try:
        return run_gan_loop(cfg, app.state, make_step_fn(app), app.rand,
                            make_test_fn(cfg, app, scorer, out_dir), out_dir, device)
    finally:
        if app.feed is not None:
            app.feed.close()


if __name__ == "__main__":
    main()
