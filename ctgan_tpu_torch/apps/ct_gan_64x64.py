"""64x64 CT-GAN with the "Good" ResNet (counterpart of
``ctgan_tpu/apps/ct_gan_64x64.py``).

    python -m ctgan_tpu_torch.apps.ct_gan_64x64 --ITERS 15 --out_dir runs/x

The flags are the fields of :class:`Config`, under the JAX app's names and
defaults (``ctgan_tpu/apps/ct_gan_64x64.py:29-63``): ``MODE`` wgan-ct,
``ARCH`` good, ``DIM`` 64, batch 64, 5 critic iterations, ``BF16`` and
``FUSE_MEANPOOL`` on.  ``CUDA_DROPOUT`` takes the place of
``PALLAS_DROPOUT`` and, like it, is on by default.  Not ported yet, and
refused: ``ARCH`` other than ``good`` (ROADMAP Queue 1 items 13 and 14),
``DATA_DIR`` and ``input`` other than ``hbm`` (item 14: the image-directory
reader and the native pipeline), ``REMAT`` and a non-fp32
``OPT_STATE_DTYPE`` (item 17).

Precision as in the flagship app: ``BF16`` sets the bf16 policy
(``core.precision``) process-wide when the run is on the card; on the CPU
the run is fp32, as the JAX app is off the accelerator; ``--BF16 0`` runs
fp32 on the card too.

Data: the JAX app's synthetic pool of 4,096 64 px images (seed ``seed``),
uint8 on the device.  Each iteration takes its ``[K, B]`` batch from the
pool with ``DeviceSampler`` at the state's step, scales it by ``2 * (x /
255 - 0.5)`` and flips each image left to right with probability 1/2
(``data.augment``, the math of ``ctgan_tpu/data/hbm_input.py:68-74``); no
dequantisation noise.  ``dcgan`` trains one critic batch per iteration.

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

from ..bridge import from_jax_params, state_from_jax, state_to_jax
from ..core import Randomness, default_policy, split_params
from ..data import DeviceSampler, scale_and_flip, synthetic_images
from ..models import good64
from ..train import GanConfig, GanState, GanTrainer, LoopConfig, train_loop
from ..utils.logging import MetricLogger
from . import common
from .common import pick_scorer, save_sample_grid, setup_out_dir

__all__ = ["App64", "Config", "check_supported", "main", "make_test_fn", "parse_config", "setup"]

CHW = (3, 64, 64)
N_POOL = 4096
GEN_CHUNK = 100  # images per generator call in the IS/FID eval (batch statistics!)
N_GRID = 64


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
    ROADMAP item; ``ValueError`` for what the JAX app refuses too."""
    if cfg.ARCH in ("dcgan", "crippled", "fc", "multiplicative"):
        raise NotImplementedError(f"ARCH {cfg.ARCH} is not ported yet: ROADMAP Queue 1 item 13")
    if cfg.ARCH == "resnet101":
        raise NotImplementedError("ARCH resnet101 is not ported yet: ROADMAP Queue 1 item 14")
    if cfg.ARCH != "good":
        raise ValueError(f"unknown ARCH {cfg.ARCH!r}")
    if cfg.DATA_DIR or cfg.input != "hbm":
        raise NotImplementedError("DATA_DIR and input other than 'hbm' (the image-directory reader, "
                                  "the native pipeline) are not ported yet: ROADMAP Queue 1 item 14")
    if cfg.REMAT or cfg.OPT_STATE_DTYPE != "float32":
        raise NotImplementedError("REMAT and OPT_STATE_DTYPE are not ported yet: ROADMAP Queue 1 item 17")


class App64(NamedTuple):
    trainer: GanTrainer
    state: GanState
    sampler: DeviceSampler
    rand: Randomness
    pool: tuple  # (flat uint8 [4096, 12288], labels [4096]) on the host


def setup(cfg: Config, device, pool: tuple | None = None) -> App64:
    """Fresh trainer and state, the pool (the synthetic 4,096 unless
    ``pool`` gives ``(flat uint8 images, labels)``), its device-resident
    sampler and the base randomness of a run of ``cfg`` on ``device``.
    Sets the process-wide precision policy: bf16 where ``cfg.BF16`` and the
    device is CUDA, else fp32."""
    check_supported(cfg)
    device = torch.device(device)
    default_policy(enable_bf16=cfg.BF16 and device.type == "cuda")

    def gen_fn(p, n, rand, noise=None):
        return good64.generator(p, n, rand, dim=cfg.DIM, noise=noise)

    def disc_fn(p, x, rand):
        return good64.discriminator(p, x, rand, dim=cfg.DIM, mode=cfg.MODE,
                                    fuse_meanpool=cfg.FUSE_MEANPOOL)

    gcfg = GanConfig(
        mode=cfg.MODE, batch_size=cfg.BATCH_SIZE, critic_iters=cfg.CRITIC_ITERS,
        lambda_gp=cfg.LAMBDA, lambda_ct=cfg.LAMBDA_2, factor_m=cfg.Factor_M, iters=cfg.ITERS,
    )
    params = good64.init_params(cfg.DIM, cfg.MODE, cfg.seed)
    tensors = {k: v.to(device) for k, v in from_jax_params(params).items()}
    gparams, dparams, rest = split_params(tensors, "Generator", "Discriminator")
    if rest:
        raise RuntimeError(f"parameters outside G and D: {sorted(rest)}")
    trainer = GanTrainer(gen_fn, disc_fn, gcfg)
    critic_iters = 1 if cfg.MODE == "dcgan" else cfg.CRITIC_ITERS
    pool = pool or synthetic_images(N_POOL, 3, 64, seed=cfg.seed)
    sampler = DeviceSampler([pool[0]], cfg.BATCH_SIZE, critic_iters, seed=cfg.seed, device=device)
    rand = Randomness(cfg.seed, device, cuda_dropout=cfg.CUDA_DROPOUT)
    return App64(trainer, trainer.init_state(gparams, dparams), sampler, rand, pool)


def make_step_fn(app: App64):
    """``step_fn(state, rand)`` for the train loop: the batch of the
    state's step from the pool, scaled and flipped, then one iteration,
    every draw from ``rand.for_step(state.step)``."""

    def step_fn(state: GanState, rand: Randomness):
        rand = rand.for_step(state.step)
        raw = app.sampler.sample(state.step)
        real = scale_and_flip(raw, rand.flip(raw.shape[0] * raw.shape[1]), CHW)
        return state, app.trainer.step(state, real, rand)

    return step_fn


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
            metrics["fid"] = float(scorer.fid(app.pool[0][: cfg.inception_samples], fakes))
        return metrics

    return test_fn


def main(argv=None, cfg: Config | None = None, device="cuda"):
    """Train to ``cfg.ITERS`` iterations on ``device``, resuming from
    ``out_dir`` when it holds a checkpoint.  Returns the final state and
    the records printed by this process."""
    cfg = cfg or parse_config(argv)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    out_dir = setup_out_dir(cfg)
    app = setup(cfg, device)
    print(f"device {device}, out_dir {out_dir}")
    scorer = None
    if cfg.inception_every:
        scorer = pick_scorer(3, 64, out_dir, train_data=app.pool, device=device)

    counter = {"i": 0}

    def next_batch():
        counter["i"] += 1
        return ()

    lcfg = LoopConfig(
        iters=cfg.ITERS, print_every=100, test_every=cfg.sample_every, save_every=cfg.save_every,
        ckpt_dir=f"{out_dir}/ckpt", allow_fresh_start=cfg.allow_fresh_start,
    )
    logger = MetricLogger(out_dir)
    state = train_loop(
        app.state, make_step_fn(app), next_batch, app.rand, lcfg, logger=logger,
        test_fn=make_test_fn(cfg, app, scorer, out_dir),
        data_state=lambda: {"i": counter["i"]},
        set_data_state=lambda s: counter.update(i=int(s["i"])),
        to_blob=state_to_jax, from_blob=lambda blob: state_from_jax(blob, device, GanState),
    )
    return state, logger.records


if __name__ == "__main__":
    main()
