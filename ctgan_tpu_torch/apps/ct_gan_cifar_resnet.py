"""Conditional ResNet/ACGAN CT-GAN on CIFAR-10, the flagship trainer
(counterpart of ``ctgan_tpu/apps/ct_gan_cifar_resnet.py``).

    python -m ctgan_tpu_torch.apps.ct_gan_cifar_resnet --ITERS 15 --out_dir runs/x
    torchrun --nproc_per_node 4 -m ctgan_tpu_torch flagship --ITERS 15 --MODEL_AXIS 2 --out_dir runs/x

The flags are the fields of :class:`Config`, under the JAX app's names and
defaults, with these differences.  ``CUDA_DROPOUT`` takes the place of
``PALLAS_DROPOUT`` and, like it, is on by default.  ``REMAT`` recomputes
each differentiated D pass in the backward instead of keeping its
activations (``train.remat``: the masks are relaunched on the same seed
slots, so the numbers are those of the plain step); ``OPT_STATE_DTYPE
bfloat16`` stores the Adam moments in bf16 (``train.optim.with_state_dtype``),
and a run resumes from a checkpoint of either package written with the same
``OPT_STATE_DTYPE``.

Several processes (``torchrun``, one per GPU; gloo on the CPU with
``--platform cpu``): as the JAX app trains over every device it sees, the
run trains over a ``data x model`` grid of its processes
(``common.maybe_mesh``, ``MODEL_AXIS`` the model axis), with one device's
semantics (``parallel.data_parallel``): each rank trains on its rows of the
global ``BATCH_SIZE`` batch (split over all ranks), draws its rows of the
one-process draws, normalises G's batch norms over the global batch and
averages the gradients over every rank before Adam; under ``MODEL_AXIS >
1`` G's input projection (and any other leaf the rules match) is stored in
shards, with its Adam moments, and gathered in each substep.  The JAX app
runs this through its unfused step because of an XLA miscompile
(``docs/XLA_GSPMD_SCAN_BUG.md``); the port has no such bug and keeps one
step (captured on the card over NCCL).  Rank 0 alone evaluates (with the
gathered parameters), prints, logs and writes checkpoints, with full
leaves in the JAX format, so a run resumes at another number of processes.

Precision.  ``BF16`` is on by default, as in the JAX app, and like the JAX
app (``ctgan_tpu/apps/ct_gan_cifar_resnet.py:87-91``) it sets the bf16
policy (``core.precision``) process-wide when the run is on the card:
conv and matmul operands in bf16, bf16 activations, fp32 norm statistics
and loss reductions, fp32 parameters, Adam moments and schedule.  On the
CPU, ``BF16`` runs fp32, exactly as the JAX app does off the accelerator.
``--BF16 0`` runs fp32 on the card too: PyTorch's default there, cuDNN
computing fp32 convolutions in TF32 and matrix products in full fp32.
Each ``main`` sets the process-wide policy from its own config.

``NORMALIZATION_D`` adds layer norms to D, label-blind under ACGAN
(``models.resnet_cifar``).  A conditional model with neither ACGAN nor
``NORMALIZATION_D`` prints the reference's warning that it may be
effectively unconditional.

The run is the JAX app's workflow through ``train.loop.train_loop``:
metrics printed on the first 5 iterations and every 100th (means since the
previous print, ``time`` in seconds per iteration) into ``log.ndjson`` and
``log.pkl``; every ``sample_every`` iterations the dev cost on the first
``BATCH_SIZE * 10`` test images and a grid of 100 fixed samples
(``samples_<it>.png``); every ``INCEPTION_FREQUENCY`` iterations the
inception score over ``inception_samples`` generated images and FID on
10,000, through ``common.pick_scorer``'s scorer: Inception-2015 when a
weight file is found, else the TrainedScorer cached in ``<out_dir>/scorer.npz``;
every ``save_every`` iterations a checkpoint ``ckpt/ckpt_<N>.npz`` in the
JAX package's format (the newest 5 kept) and ``params_latest.npz``.  Run it
again with the same ``out_dir`` and it resumes, also from a checkpoint the
JAX app wrote.  Every iteration's draws are a function of ``(seed, step)``,
so a resumed run trains as an uninterrupted one would.  On the card each
iteration is one replay of a CUDA graph (``LoopConfig.jit_step``, the
default): the batch's indices go to the device in the step's input buffer
and the pool is gathered inside the graph.

Entry points run on ``cuda``; ``main(..., device="cpu")`` runs on the CPU
with the dropout kernel's plain version.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..bridge import from_jax_params, state_from_jax, state_to_jax
from ..core import Randomness, default_policy, format_param_table, split_params
from ..data import DeviceSampler, load_arrays
from ..models import resnet_cifar
from ..parallel import Mesh, data_parallel, fetch_full_params, fetch_full_state, shard_state
from ..train import AcganConfig, AcganState, AcganTrainer, LoopConfig, train_loop
from ..utils.logging import MetricLogger
from . import common
from .common import is_main, pick_scorer, require_device, save_sample_grid, setup_out_dir

__all__ = ["Config", "Flagship", "main", "make_step_fn", "make_test_fn", "parse_config", "setup"]

GEN_CHUNK = 5000  # images per generator call in the IS/FID eval (batch statistics!)
N_GRID = 100


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
    INCEPTION_FREQUENCY: int = 1000
    CONDITIONAL: bool = True
    ACGAN: bool = True
    ACGAN_SCALE: float = 1.0
    ACGAN_SCALE_G: float = 0.1
    n_examples: int = 50000
    DATA_DIR: str = ""
    BF16: bool = True
    CUDA_DROPOUT: bool = True
    CLEAN_PASS: bool = True
    REMAT: bool = False
    OPT_STATE_DTYPE: str = "float32"
    FUSE_CT_PASSES: bool = True
    FUSE_MEANPOOL: bool = True
    MODEL_AXIS: int = 1
    seed: int = 0
    allow_fresh_start: bool = False
    out_dir: str = "runs/ct_gan_cifar_resnet"
    inception_samples: int = 50000
    sample_every: int = 100
    save_every: int = 1000


def parse_config(argv=None) -> Config:
    return common.parse_config(Config, argv)


class Flagship(NamedTuple):
    trainer: AcganTrainer
    state: AcganState
    sampler: DeviceSampler
    rand: Randomness
    data: dict  # load_arrays: {"train": (x, y), "test": (x, y)}
    mesh: Mesh | None = None  # the process grid of a run over several processes
    specs: dict | None = None  # the state's spec trees over the mesh
    eval_trainer: AcganTrainer | None = None  # the one-device trainer of the evaluation


def setup(cfg: Config, device, mesh=None) -> Flagship:
    """Fresh trainer and state, the data, the device-resident sampler and
    the base randomness of a run of ``cfg`` on ``device``.  Sets the
    process-wide precision policy: bf16 where ``cfg.BF16`` and the device is
    CUDA, else fp32.  Over a ``mesh`` the trainer, state, sampler and
    randomness are this rank's (``parallel.data_parallel``)."""
    device = torch.device(device)
    default_policy(enable_bf16=cfg.BF16 and device.type == "cuda")
    if cfg.CONDITIONAL and not cfg.ACGAN and not cfg.NORMALIZATION_D:
        print("WARNING! Conditional model without normalization in D might be "
              "effectively unconditional!")
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
        fuse_ct_passes=cfg.FUSE_CT_PASSES, clean_pass=cfg.CLEAN_PASS, remat=cfg.REMAT,
        opt_state_dtype=cfg.OPT_STATE_DTYPE,
    )

    def gen_fn(p, n, labels, rand, noise=None):
        return resnet_cifar.generator(p, n, labels, mcfg, rand, noise=noise)

    def disc_fn(p, x, labels, kps, rand):
        return resnet_cifar.discriminator(p, x, labels, kps, mcfg, rand)

    params = {k: v.to(device) for k, v in from_jax_params(resnet_cifar.init_params(mcfg, cfg.seed)).items()}
    gparams, dparams, rest = split_params(params, "Generator", "Discriminator")
    if rest:
        raise RuntimeError(f"parameters outside G and D: {sorted(rest)}")
    data = load_arrays(cfg.DATA_DIR or None, n_examples=cfg.n_examples)
    if mesh is None:
        trainer = AcganTrainer(gen_fn, disc_fn, tcfg)
        state, specs, rank, world = trainer.init_state(gparams, dparams), None, 0, 1
    else:
        trainer, state, specs = data_parallel(mesh, AcganTrainer, gen_fn, disc_fn, tcfg, gparams, dparams)
        rank, world = mesh.rank, mesh.world
    sampler = DeviceSampler(list(data["train"]), cfg.BATCH_SIZE, cfg.N_CRITIC, seed=cfg.seed,
                            device=device, rank=rank, world=world)
    rand = Randomness(cfg.seed, device, cuda_dropout=cfg.CUDA_DROPOUT, rank=rank, world=world)
    eval_trainer = trainer if mesh is None else AcganTrainer(gen_fn, disc_fn, tcfg)
    return Flagship(trainer, state, sampler, rand, data, mesh, specs, eval_trainer)


def make_step_fn(flagship: Flagship):
    """``step_fn(state, idx, rand)`` for the train loop: the pool's images
    and labels at the iteration's ``K * B`` indices ``idx``
    (``sampler.host_indices``), gathered on the device, then one iteration,
    every draw from ``rand.for_step(state.step)``."""

    def step_fn(state: AcganState, idx: torch.Tensor, rand: Randomness):
        real_stack, label_stack = flagship.sampler.gather(idx)
        return state, flagship.trainer.step(state, real_stack, label_stack, rand.for_step(state.step))

    return step_fn


def make_test_fn(cfg: Config, flagship: Flagship, scorer, out_dir: str):
    """The JAX app's ``test_fn(state, iteration) -> metrics``: dev cost on
    the first ``BATCH_SIZE * 10`` test images in one call, the fixed
    100-sample grid, and on the inception cadence IS and FID.  Each part
    draws from its own fixed seed, as the JAX app uses fixed keys.  Over a
    mesh every rank gathers the full parameters and rank 0 evaluates with
    the one-device trainer while the others wait; they return no
    metrics."""
    trainer, device = flagship.eval_trainer or flagship.trainer, flagship.rand.device
    dev_images, dev_labels = flagship.data["test"]
    n_dev = cfg.BATCH_SIZE * 10
    dev_x = torch.from_numpy(dev_images[:n_dev]).to(device)
    dev_y = torch.from_numpy(dev_labels[:n_dev]).to(device)
    fixed_noise = torch.from_numpy(
        np.random.default_rng(cfg.seed).normal(size=(N_GRID, 128)).astype("f4")).to(device)
    fixed_labels = torch.arange(N_GRID, device=device) % 10
    real_sub = dev_images[: min(len(dev_images), 10000)]

    def rand(seed: int) -> Randomness:
        return Randomness(seed, device, cuda_dropout=cfg.CUDA_DROPOUT)

    def generate_u8(state, n: int, seed: int) -> torch.Tensor:
        flat, _ = trainer.generate(state, n, rand(seed))
        return ((flat + 1.0) * (255.99 / 2)).to(torch.uint8)

    def test_fn(state, iteration: int) -> dict:
        metrics = {"dev_cost": float(trainer.dev_cost(state, dev_x, dev_y, rand(1)))}
        samples = trainer.sample(state, fixed_noise, fixed_labels, rand(0))
        save_sample_grid(samples, (3, 32, 32), f"{out_dir}/samples_{iteration}.png")
        freq = cfg.INCEPTION_FREQUENCY
        if freq and iteration % freq == freq - 1:
            chunks = [generate_u8(state, GEN_CHUNK, i) for i in range(0, cfg.inception_samples, GEN_CHUNK)]
            all_samples = torch.cat(chunks)[: cfg.inception_samples]
            m, s = scorer.inception_score(all_samples)
            metrics["inception_50k"] = m
            metrics["inception_50k_std"] = s
            metrics["fid_10k"] = scorer.fid(real_sub, all_samples[: len(real_sub)])
        return metrics

    mesh, specs = flagship.mesh, flagship.specs
    if mesh is None:
        return test_fn

    def test_on_rank0(state, iteration: int) -> dict:
        full = dataclasses.replace(state, gen_params=fetch_full_params(state.gen_params, mesh, specs["gen_params"]),
                                   disc_params=fetch_full_params(state.disc_params, mesh, specs["disc_params"]))
        metrics = test_fn(full, iteration) if mesh.rank == 0 else {}
        mesh.barrier()
        return metrics

    return test_on_rank0


def state_io(flagship: Flagship, device) -> tuple:
    """``(to_blob, from_blob)`` of the train loop: the JAX layout, and over
    a mesh the full leaves gathered (every rank) and each rank's shards of a
    loaded state."""
    mesh, specs = flagship.mesh, flagship.specs
    if mesh is None:
        return state_to_jax, lambda blob: state_from_jax(blob, device)
    return (lambda state: state_to_jax(fetch_full_state(state, mesh, specs)),
            lambda blob: shard_state(state_from_jax(blob, device), mesh, specs))


def main(argv=None, cfg: Config | None = None, device="cuda"):
    """Train to ``cfg.ITERS`` iterations on ``device``, resuming from
    ``out_dir`` when it holds a checkpoint.  Returns the final state and
    the records printed by this process."""
    cfg = cfg or parse_config(argv)
    device = require_device(device)
    mesh = common.maybe_mesh(model_axis=cfg.MODEL_AXIS, device=device)
    device = mesh.device if mesh is not None else device
    main_rank = is_main(mesh)
    out_dir = setup_out_dir(cfg) if main_rank else cfg.out_dir
    flagship = setup(cfg, device, mesh)
    if main_rank:
        print(format_param_table(flagship.state.gen_params, "G Params"))
        print(format_param_table(flagship.state.disc_params, "D Params"))
        print(f"device {device}, out_dir {out_dir}")
        if mesh is not None:
            print(f"mesh: data {mesh.data} x model {mesh.model} over {mesh.backend}, "
                  f"{cfg.BATCH_SIZE // mesh.world} rows of each batch per rank (shapes above: rank 0's storage)")
    scorer = pick_scorer(3, 32, out_dir, train_data=flagship.data["train"], device=device) if main_rank else None
    test_fn = make_test_fn(cfg, flagship, scorer, out_dir)

    counter = {"i": 0}

    def next_batch():
        i = counter["i"]
        counter["i"] += 1
        return (flagship.sampler.host_indices(i),)

    lcfg = LoopConfig(
        iters=cfg.ITERS, print_every=100, test_every=cfg.sample_every, save_every=cfg.save_every,
        ckpt_dir=f"{out_dir}/ckpt", allow_fresh_start=cfg.allow_fresh_start, keep_checkpoints=5,
    )
    logger = MetricLogger(out_dir, quiet=not main_rank)
    to_blob, from_blob = state_io(flagship, device)
    state = train_loop(
        flagship.state, make_step_fn(flagship), next_batch, flagship.rand, lcfg, logger=logger, test_fn=test_fn,
        data_state=lambda: {"i": counter["i"]},
        set_data_state=lambda s: counter.update(i=int(s["i"])),
        to_blob=to_blob, from_blob=from_blob, mesh=mesh,
    )
    return state, logger.records


if __name__ == "__main__":
    main()
