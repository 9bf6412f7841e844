"""Entry points of the flagship model (counterpart of ``__graft_entry__.py``).

* :func:`entry`: the flagship forward (the conditional ResNet CT-GAN for
  CIFAR-10 at dim 128) and example arguments: G on 8 noise vectors, then
  one D pass over real‖fake with the training keep probabilities.
* :func:`dryrun_multichip`: the multi-device dry run.  One flagship
  iteration at dim 16 (a G update and 2 critic updates with the
  consistency term, the gradient penalty's double backward and the ACGAN
  cross-entropy) over an n-rank ``data x model`` mesh, ``model = 2`` when
  n is even and at least 4, as the JAX package picks it; then, on a model
  axis, one step of the library's per-device trainer
  (``parallel.make_spmd_trainer``).

Both run on the card unless the caller asks for the CPU; there D's
dropout masks come from the hand-written mask kernel
(``kernels.dropout_mask``).  The dry run never falls back to fewer ranks
or to the CPU: too few visible cards raise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .bridge import from_jax_params
from .core import Randomness
from .kernels import dropout_mask, philox_uniform
from .models import resnet_cifar
from .parallel import data_parallel, local_rows, make_mesh, make_spmd_trainer
from .parallel.launch import run_ranks
from .train import AcganConfig, AcganTrainer

__all__ = ["dryrun_multichip", "entry"]

ENTRY_DIM, ENTRY_BATCH = 128, 8
DRYRUN_DIM, DRYRUN_CRITIC_ITERS = 16, 2
METRICS = ("disc_cost", "gen_cost", "ct", "gp", "acgan")


def _flagship_params(dim: int, device) -> tuple[dict, dict]:
    """(G's, D's) fresh flagship parameters in the port's layout on
    ``device``: the port's init, equal to the JAX package's at seed 0."""
    params = from_jax_params(resnet_cifar.init_params(resnet_cifar.ResnetCifarConfig(dim_g=dim, dim_d=dim), 0))
    split = lambda prefix: {k: v.to(device) for k, v in params.items() if k.startswith(prefix)}
    return split("Generator"), split("Discriminator")


def entry(device="cuda", *, cuda_dropout: bool = True):
    """``(fn, args)``: ``fn(params, noise, labels, real, rand)`` runs G at
    dim 128 on ``noise`` ``[8, 128]`` and ``labels`` ``[8]``, then D over
    ``real`` ``[8, 3072]`` (in [-1, 1]) followed by the fakes, keep
    probabilities 0.8 / 0.5 / 0.5, and returns D's ``(wgan, acgan)``
    outputs ``([16], [16, 10])``.  ``args`` holds the flagship's fresh
    parameters on ``device``, the JAX entry's noise, labels and reals, and
    a randomness provider seeded 7 (``cuda_dropout`` False: the plain mask
    on the card).  Each call of ``fn`` draws the provider's next three
    masks."""
    device = torch.device(device)
    cfg = resnet_cifar.ResnetCifarConfig(dim_g=ENTRY_DIM, dim_d=ENTRY_DIM)
    gen, disc = _flagship_params(ENTRY_DIM, device)
    noise = torch.from_numpy(np.random.default_rng(0).normal(size=(ENTRY_BATCH, 128)).astype(np.float32))
    labels = torch.arange(ENTRY_BATCH) % 10
    real = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, size=(ENTRY_BATCH, 3072)).astype(np.float32))

    def fn(params, noise, labels, real, rand):
        fake = resnet_cifar.generator(params, noise.shape[0], labels, cfg, rand, noise=noise)
        out = resnet_cifar.discriminator(params, torch.cat([real, fake]), torch.cat([labels, labels]),
                                         (0.8, 0.5, 0.5), cfg, rand)
        return out.wgan, out.acgan

    rand = Randomness(7, device, cuda_dropout=cuda_dropout)
    return fn, ({**gen, **disc}, noise.to(device), labels.to(device), real.to(device), rand)


def mesh_shape(n: int) -> tuple[int, int]:
    """``(data, model)`` of the dry run's mesh over ``n`` ranks."""
    model = 2 if n % 2 == 0 and n >= 4 else 1
    return n // model, model


def _dryrun_parts(n: int, device):
    """The dry run's trainer pieces and inputs: the flagship at dim 16, the
    global batch ``2 * data``, and ``default_rng(0)``'s uint8 reals and
    labels, ``[K, B, 3072]`` and ``[K, B]``, for the step and then for the
    per-device step."""
    data, _ = mesh_shape(n)
    batch = 2 * data
    mcfg = resnet_cifar.ResnetCifarConfig(dim_g=DRYRUN_DIM, dim_d=DRYRUN_DIM)
    gen_fn = lambda p, k, labels, rand, noise=None: resnet_cifar.generator(p, k, labels, mcfg, rand, noise=noise)
    disc_fn = lambda p, x, labels, kps, rand: resnet_cifar.discriminator(p, x, labels, kps, mcfg, rand)
    cfg = AcganConfig(batch_size=batch, critic_iters=DRYRUN_CRITIC_ITERS, iters=10, gen_bs_multiple=2)
    rng = np.random.default_rng(0)
    inputs = []
    for _ in range(2):
        real = rng.integers(0, 256, size=(DRYRUN_CRITIC_ITERS, batch, 3072)).astype(np.uint8)
        labels = rng.integers(0, 10, size=(DRYRUN_CRITIC_ITERS, batch))
        inputs.append((torch.from_numpy(real).to(device), torch.from_numpy(labels).to(device)))
    return gen_fn, disc_fn, cfg, *_flagship_params(DRYRUN_DIM, device), inputs


def _floats(metrics: dict) -> dict:
    return {k: float(v) for k, v in sorted(metrics.items())}


def dryrun_step(n: int, device="cuda", mesh=None) -> dict:
    """The dry run's iteration at step 0 of the flagship trainer, the global
    batch of an ``n``-rank run: over ``mesh`` with one device's semantics
    (``parallel.data_parallel``, each rank its rows of the batch and of the
    one-process draws), or in one process without it.  The metrics."""
    device = torch.device(device)
    gen_fn, disc_fn, cfg, gen, disc, inputs = _dryrun_parts(n, device)
    batches = inputs[0]
    if mesh is None:
        trainer = AcganTrainer(gen_fn, disc_fn, cfg)
        state = trainer.init_state(gen, disc)
        rand = Randomness(0, device)
    else:
        trainer, state, _ = data_parallel(mesh, AcganTrainer, gen_fn, disc_fn, cfg, gen, disc)
        rand = Randomness(0, device, rank=mesh.rank, world=mesh.world)
        batches = [local_rows(mesh, b, 1) for b in batches]
    return _floats(trainer.step(state, *batches, rand.for_step(0)))


def _dryrun_rank(rank: int, world: int, device_type: str) -> dict:
    """One rank of :func:`dryrun_multichip`: the step over the mesh, then on
    a model axis the per-device step; the metrics and this process's
    kernel launches."""
    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    data, model = mesh_shape(world)
    mesh = make_mesh(data=data, model=model, device=device)
    out = {"step": dryrun_step(world, device, mesh)}
    if model > 1:
        gen_fn, disc_fn, cfg, gen, disc, inputs = _dryrun_parts(world, device)
        state, spmd_step, _ = make_spmd_trainer(gen_fn, disc_fn, cfg, mesh, gen, disc, flavor="acgan")
        _, metrics = spmd_step(state, *inputs[1], Randomness(1, device).for_step(0))
        out["spmd"] = _floats(metrics)
    out["launches"] = {"dropout_mask": dropout_mask.launches, "philox_uniform": philox_uniform.launches}
    return out


def dryrun_multichip(n: int, device="cuda", *, timeout: float = 600.0, join_timeout: float = 120.0) -> dict:
    """The multi-device dry run over ``n`` ranks: one process per card over
    NCCL (``device="cuda"``; fewer than ``n`` visible cards raise), or
    ``n`` gloo processes on the CPU (``device="cpu"``).  Prints one line
    per mode and returns ``{"mesh": (data, model), "step": metrics,
    ["spmd": metrics,] "launches": {kernel: launches over the ranks}}``.
    Every rank must report the same finite ``disc_cost``, ``gen_cost``,
    ``ct``, ``gp`` and ``acgan``.  A rank that fails, or a group still
    running after ``timeout`` seconds (a collective after
    ``join_timeout``), ends every rank and raises."""
    device_type = torch.device(device).type
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: cuda or cpu")
    ranks = run_ranks(n, _dryrun_rank, (device_type,), backend="nccl" if device_type == "cuda" else "gloo",
                      timeout=timeout, join_timeout=join_timeout)
    data, model = mesh_shape(n)
    out = {"mesh": (data, model)}
    for mode in ("step", "spmd") if model > 1 else ("step",):
        metrics = ranks[0][mode]
        for name in METRICS:
            values = [r[mode][name] for r in ranks]
            if not all(math.isfinite(v) for v in values) or len(set(values)) != 1:
                raise RuntimeError(f"dryrun_multichip({n}) {mode}: {name} per rank {values}")
        out[mode] = metrics
        what = "fused-SPMD (per-device) step" if mode == "spmd" else f"mesh=data{data}xmodel{model} step"
        print(f"dryrun_multichip({n}): {what} ok; " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()),
              flush=True)
    out["launches"] = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    return out
