"""Conditional ResNet/ACGAN CT-GAN on CIFAR-10, the flagship trainer
(counterpart of ``ctgan_tpu/apps/ct_gan_cifar_resnet.py``).

    python -m ctgan_tpu_torch.apps.ct_gan_cifar_resnet --ITERS 15

The flags are the fields of :class:`Config`, under the JAX app's names and
defaults, with these differences.  Runs are fp32: ``BF16`` defaults to off
and raises if set (the bf16 policy is a later slice).  ``CUDA_DROPOUT``
takes the place of ``PALLAS_DROPOUT`` and, like it, is on by default.
Checkpoints, sample grids and the inception score (``save_every``,
``sample_every``, ``INCEPTION_FREQUENCY``), ``REMAT``, ``OPT_STATE_DTYPE``
and ``MODEL_AXIS`` come with later slices and are not fields yet.

Metrics are printed on the JAX loop's cadence (the first 5 iterations, every
100th and the last) as means since the previous print, with ``time`` the
seconds per iteration over the same span, and appended to
``<out_dir>/log.ndjson``.  ``out_dir`` defaults to a new temporary
directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import tempfile
import time
from dataclasses import dataclass

import torch

from ..bridge import from_jax_params
from ..core import Randomness, param_count, split_params
from ..data import DeviceSampler, load_train
from ..models import resnet_cifar
from ..train import AcganConfig, AcganTrainer

__all__ = ["Config", "main", "parse_config", "setup"]

PRINT_FIRST = 5
PRINT_EVERY = 100


@dataclass(frozen=True)
class Config:
    LAMBDA_2: float = 2.0
    Factor_M: float = 0.0
    BATCH_SIZE: int = 64
    GEN_BS_MULTIPLE: int = 2
    ITERS: int = 100000
    DIM_G: int = 128
    DIM_D: int = 128
    NORMALIZATION_G: bool = True
    NORMALIZATION_D: bool = False
    LR: float = 2e-4
    DECAY: bool = True
    N_CRITIC: int = 5
    CONDITIONAL: bool = True
    ACGAN: bool = True
    ACGAN_SCALE: float = 1.0
    ACGAN_SCALE_G: float = 0.1
    n_examples: int = 50000
    DATA_DIR: str = ""
    BF16: bool = False
    CUDA_DROPOUT: bool = True
    CLEAN_PASS: bool = True
    FUSE_CT_PASSES: bool = True
    FUSE_MEANPOOL: bool = True
    seed: int = 0
    out_dir: str = ""


def parse_config(argv=None) -> Config:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for f in dataclasses.fields(Config):
        if f.type in ("bool", bool):
            parser.add_argument("--" + f.name, default=f.default,
                                type=lambda s: s.lower() in ("1", "true", "yes"))
        else:
            parser.add_argument("--" + f.name, type=type(f.default), default=f.default)
    return Config(**vars(parser.parse_args(argv)))


def setup(cfg: Config, device: torch.device):
    """Fresh trainer and state, the device-resident data sampler and the
    randomness of a run of ``cfg`` on ``device``."""
    if cfg.BF16:
        raise NotImplementedError("BF16: the bf16 policy is not ported yet; runs are fp32")
    mcfg = resnet_cifar.ResnetCifarConfig(
        dim_g=cfg.DIM_G, dim_d=cfg.DIM_D, conditional=cfg.CONDITIONAL, acgan=cfg.ACGAN,
        normalization_g=cfg.NORMALIZATION_G, normalization_d=cfg.NORMALIZATION_D,
        fuse_meanpool=cfg.FUSE_MEANPOOL,
    )
    tcfg = AcganConfig(
        batch_size=cfg.BATCH_SIZE, critic_iters=cfg.N_CRITIC, lambda_ct=cfg.LAMBDA_2,
        factor_m=cfg.Factor_M, lr=cfg.LR, iters=cfg.ITERS, decay=cfg.DECAY,
        gen_bs_multiple=cfg.GEN_BS_MULTIPLE, conditional=cfg.CONDITIONAL, acgan=cfg.ACGAN,
        acgan_scale=cfg.ACGAN_SCALE, acgan_scale_g=cfg.ACGAN_SCALE_G,
        fuse_ct_passes=cfg.FUSE_CT_PASSES, clean_pass=cfg.CLEAN_PASS,
    )

    def gen_fn(p, n, labels, rand, noise=None):
        return resnet_cifar.generator(p, n, labels, mcfg, rand, noise=noise)

    def disc_fn(p, x, labels, kps, rand):
        return resnet_cifar.discriminator(p, x, labels, kps, mcfg, rand)

    params = {k: v.to(device) for k, v in from_jax_params(resnet_cifar.init_params(mcfg, cfg.seed)).items()}
    gparams, dparams, rest = split_params(params, "Generator", "Discriminator")
    if rest:
        raise RuntimeError(f"parameters outside G and D: {sorted(rest)}")
    trainer = AcganTrainer(gen_fn, disc_fn, tcfg)
    state = trainer.init_state(gparams, dparams)
    images, labels = load_train(cfg.DATA_DIR or None, n_examples=cfg.n_examples)
    sampler = DeviceSampler([images, labels], cfg.BATCH_SIZE, cfg.N_CRITIC, seed=cfg.seed,
                            device=device)
    rand = Randomness(cfg.seed, device, cuda_dropout=cfg.CUDA_DROPOUT)
    return trainer, state, sampler, rand


def main(argv=None, cfg: Config | None = None, device="cuda"):
    """Train ``cfg.ITERS`` iterations on ``device``.  Returns the final
    state and the printed records (dicts of metric means)."""
    cfg = cfg or parse_config(argv)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    out_dir = cfg.out_dir or tempfile.mkdtemp(prefix="ctgan_tpu_torch_")
    os.makedirs(out_dir, exist_ok=True)
    print("Settings: " + ", ".join(f"{k}={v!r}" for k, v in dataclasses.asdict(cfg).items()))
    print(f"device {device}, out_dir {out_dir}")

    trainer, state, sampler, rand = setup(cfg, device)
    print(f"G params: {param_count(state.gen_params):,}  D params: {param_count(state.disc_params):,}")

    records, pending = [], []
    last_t, last_it = time.perf_counter(), -1
    for it in range(cfg.ITERS):
        real_stack, label_stack = sampler.sample(it)
        metrics = trainer.step(state, real_stack, label_stack, rand)
        names = sorted(metrics)
        pending.append(torch.stack([metrics[k].float() for k in names]))
        if it < PRINT_FIRST or it % PRINT_EVERY == PRINT_EVERY - 1 or it == cfg.ITERS - 1:
            means = torch.stack(pending).mean(dim=0).tolist()  # waits for the device
            now = time.perf_counter()
            record = {"iteration": it, **dict(zip(names, means)),
                      "time": (now - last_t) / (it - last_it)}
            pending.clear()
            last_t, last_it = now, it
            bad = [k for k in names if not math.isfinite(record[k])]
            if bad:
                raise FloatingPointError(f"non-finite metrics at iteration {it}: {bad}")
            print(f"iter {it}\t" + "\t".join(f"{k}\t{record[k]:.5f}" for k in [*names, "time"]),
                  flush=True)
            with open(os.path.join(out_dir, "log.ndjson"), "a") as f:
                f.write(json.dumps(record) + "\n")
            records.append(record)
    return state, records


if __name__ == "__main__":
    main()
