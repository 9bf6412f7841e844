"""The processes of ``tests/test_torch_parallel*.py``: a group of gloo ranks
on the CPU, spawned with a ``FileStore`` (no ports), each running named
cases and handing back NumPy results; and the cases themselves, which run
the same code with one process (no mesh) for the reference.

This module imports ``torch`` and ``ctgan_tpu_torch`` only, so that the
spawned processes start quickly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import multiprocessing
import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ctgan_tpu_torch.bridge import from_jax_params, state_to_jax
from ctgan_tpu_torch.core.rng import Randomness, row_segments
from ctgan_tpu_torch.models import dcgan, resnet_cifar
from ctgan_tpu_torch.ops.norm import batchnorm, cond_batchnorm
from ctgan_tpu_torch.parallel import data_parallel, fetch_full_state, local_rows, make_mesh, make_spmd_trainer
from ctgan_tpu_torch.train import AcganConfig, AcganTrainer, GanConfig, GanTrainer

JOIN_TIMEOUT = 60.0  # seconds a rendezvous or a collective may wait before the group fails
MNIST_DIM, FLAGSHIP_DIM = 8, 16


# ------------------------------------------------------------------ the group

def run_group(world: int, cases: list[tuple[str, dict]], tmp: Path, timeout: float = 240.0) -> list[dict]:
    """Run ``cases`` (``(name, kwargs)``: the function of this module that
    ``name`` names before any ``:``) in ``world`` spawned gloo ranks;
    returns each rank's ``{name: result}``.  A rank that fails, or a group
    still running after ``timeout`` seconds, kills every rank and raises
    with the ranks' errors."""
    return run_groups([(world, cases, tmp)], timeout)[0]


def run_groups(groups: list[tuple[int, list, Path]], timeout: float = 240.0) -> list[list[dict]]:
    """:func:`run_group` for several groups at once, side by side."""
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for world, cases, tmp in groups:
        tmp = Path(tmp)
        tmp.mkdir(parents=True, exist_ok=True)
        store = str(tmp / f"store_{time.monotonic_ns()}")
        procs.append([ctx.Process(target=_child, args=(rank, world, store, cases, str(tmp / f"rank{rank}")))
                      for rank in range(world)])
    flat = [p for group in procs for p in group]
    for p in flat:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in flat):
            if time.monotonic() > deadline or any(p.exitcode not in (None, 0) for p in flat):
                break
            time.sleep(0.05)
    finally:
        for p in flat:
            if p.is_alive():
                p.kill()
            p.join()
    results = []
    for (world, _, tmp), group in zip(groups, procs):
        tmp = Path(tmp)
        errors = [(tmp / f"rank{r}.err").read_text() for r in range(world) if (tmp / f"rank{r}.err").exists()]
        if errors or any(p.exitcode != 0 for p in flat):
            raise AssertionError(f"{world} ranks: exit codes {[p.exitcode for p in group]}\n" + "\n".join(errors))
        results.append([pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(world)])
    return results


def _child(rank: int, world: int, store: str, cases, out: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=JOIN_TIMEOUT))
        results = {name: globals()[name.split(":")[0]](**kwargs) for name, kwargs in cases}
        Path(out + ".pkl").write_bytes(pickle.dumps(results))
    except BaseException:
        Path(out + ".err").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _mesh(model: int):
    """The mesh of the spawned group, or None in the reference process."""
    if not dist.is_initialized():
        return None
    return make_mesh(data=dist.get_world_size() // model, model=model)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


# ------------------------------------------------------------------ the mesh

def mesh_facts() -> dict:
    """This rank's place in grids of the group, the error of a grid that
    does not match it, and the rules on a ``data 2 x model 2`` grid."""
    from ctgan_tpu_torch.parallel import effective_param_specs, shard_params

    m22, m41, default = make_mesh(data=2, model=2), make_mesh(data=4, model=1), make_mesh()
    try:
        make_mesh(data=3, model=2)
        error = None
    except ValueError as exc:
        error = str(exc)
    # port layout ([out, in]): G's input projection 128 -> 256, D's head 33 -> 1
    specs = effective_param_specs(m22, {"Generator.Input.W": torch.zeros(256, 128),
                                        "Discriminator.Output.W": torch.zeros(1, 33)})
    rows = torch.arange(256.0)[:, None].repeat(1, 128)
    shard = shard_params(m22, {"Generator.Input.W": rows, "Generator.1.b": torch.zeros(3)})
    return {"2x2": (m22.data_index, m22.model_index), "4x1": (m41.data_index, m41.model_index),
            "default": (default.data, default.model), "3x2": error, "specs": specs,
            "shard": tuple(shard["Generator.Input.W"].shape), "shard_value": float(shard["Generator.Input.W"][0, 0]),
            "group_sizes": tuple(dist.get_world_size(g) for g in (m22.data_group, m22.model_group, m22.world_group))}


# ------------------------------------------------------------------ batch norm

def norm(x: np.ndarray, labels: np.ndarray, scale: np.ndarray, offset: np.ndarray, cot: np.ndarray,
         cond: bool) -> dict:
    """(Conditional) batch norm of this rank's rows of ``x`` over the whole
    group, and the backward of ``sum(out * cot)``: the rank's output rows,
    input gradient rows and its share of the scale and offset gradients."""
    group = dist.group.WORLD if dist.is_initialized() else None
    rank, world = (dist.get_rank(), dist.get_world_size()) if group else (0, 1)
    n = x.shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    xr = torch.tensor(x[rows], requires_grad=True)
    s, o = torch.tensor(scale, requires_grad=True), torch.tensor(offset, requires_grad=True)
    if cond:
        out = cond_batchnorm(xr, torch.from_numpy(labels[rows]), s, o, group=group)
    else:
        out = batchnorm(xr, s, o, group=group)
    (out * torch.from_numpy(cot[rows])).sum().backward()
    return {"out": out.detach().numpy(), "dx": xr.grad.numpy(), "dscale": s.grad.numpy(),
            "doffset": o.grad.numpy()}


# ------------------------------------------------------------------ draws

class SlicedDraws:
    """Another package's draws of one process (global arrays), handed out
    as rank ``rank`` of ``world``'s rows, as ``core.rng.Randomness`` hands
    out its own: masks and dequantisation noise by the pass's row segments
    (``rows``), host draws by rows.  ``world`` 1: the arrays as they are
    (each rank of a per-device run the same)."""

    def __init__(self, draws: dict, rank: int = 0, world: int = 1):
        self.rank, self.world, self._blocks = rank, world, 1
        self._lists = {k: list(v) for k, v in draws.items()}

    def for_rank(self, index: int) -> "SlicedDraws":
        return self

    @contextlib.contextmanager
    def rows(self, blocks: int):
        before, self._blocks = self._blocks, blocks
        try:
            yield self
        finally:
            self._blocks = before

    def exhausted(self) -> bool:
        return not any(self._lists.values())

    def _take(self, kind: str) -> np.ndarray:
        return self._lists[kind].pop(0)

    def _segments(self, full: np.ndarray, shape) -> np.ndarray:
        flat = full.reshape(-1)
        segs = row_segments(tuple(shape), self.rank, self.world, self._blocks)
        return np.concatenate([flat[a:a + c] for a, c in segs]).reshape(shape)

    def _rows(self, full: np.ndarray, n: int) -> np.ndarray:
        assert full.shape[0] == n * self.world, (full.shape, n, self.world)
        return full[self.rank * n:(self.rank + 1) * n]

    def dropout_mask(self, shape, keep_prob, dtype, device):
        keep, kp = self._take("masks")
        assert kp == keep_prob
        mask = np.where(self._segments(keep, shape), np.float32(1.0 / kp), np.float32(0.0))
        return torch.from_numpy(mask).to(device=device, dtype=dtype)

    def noise(self, n, dim):
        return torch.from_numpy(self._rows(self._take("noises"), n))

    def labels(self, n, n_labels):
        return torch.from_numpy(self._rows(self._take("labels"), n).astype(np.int64))

    def gp_alpha(self, n):
        return torch.from_numpy(self._rows(self._take("gp_alpha"), n))

    def dequant(self, shape):
        return torch.from_numpy(self._segments(self._take("dequant"), shape))


# ------------------------------------------------------------------ trainers

def _mnist_trainer_parts(mode: str, params: dict, batch: int, critic_iters: int):
    gen_fn = lambda p, n, rand, noise=None: dcgan.mnist_generator(p, n, rand, dim=MNIST_DIM, mode=mode,
                                                                  noise=noise)
    disc_fn = lambda p, x, rand: dcgan.mnist_discriminator(p, x, rand, dim=MNIST_DIM, mode=mode)
    cfg = GanConfig(mode=mode, batch_size=batch, critic_iters=critic_iters, iters=100)
    port = from_jax_params(params)
    gen = {k: v for k, v in port.items() if k.startswith("Generator")}
    disc = {k: v for k, v in port.items() if k.startswith("Discriminator")}
    return gen_fn, disc_fn, cfg, gen, disc


def _flagship_parts(params: dict, batch: int, critic_iters: int):
    mcfg = resnet_cifar.ResnetCifarConfig(dim_g=FLAGSHIP_DIM, dim_d=FLAGSHIP_DIM)
    gen_fn = lambda p, n, labels, rand, noise=None: resnet_cifar.generator(p, n, labels, mcfg, rand, noise=noise)
    disc_fn = lambda p, x, labels, kps, rand: resnet_cifar.discriminator(p, x, labels, kps, mcfg, rand)
    cfg = AcganConfig(batch_size=batch, critic_iters=critic_iters, iters=10, gen_bs_multiple=2)
    port = from_jax_params(params)
    gen = {k: v for k, v in port.items() if k.startswith("Generator")}
    disc = {k: v for k, v in port.items() if k.startswith("Discriminator")}
    return gen_fn, disc_fn, cfg, gen, disc


def _report(trainer_state, mesh, specs, metrics: list) -> dict:
    full = fetch_full_state(trainer_state, mesh, specs)
    stored = {k: tuple(v.shape) for k, v in {**trainer_state.gen_params, **trainer_state.disc_params}.items()}
    return {"state": _np_tree(state_to_jax(full)), "metrics": metrics, "stored": stored}


def train_steps(flavor: str, params: dict, real: np.ndarray, labels: np.ndarray | None = None, *,
                mode: str = "wgan-CT", model: int = 1, iters: int = 2, seed: int = 3,
                draws: list | None = None, start_step: int = 0, cfg_fields: dict | None = None) -> dict:
    """``iters`` iterations of the unconditional (``flavor`` "gan", MNIST
    conv nets) or the flagship trainer ("acgan") on the global stack
    ``real`` (``[K, B, D]``; ``labels`` ``[K, B]``), over the group's mesh
    with one device's semantics (``parallel.data_parallel``), or in one
    process without a mesh.  Draws: the port's own from ``seed``, or
    ``draws[i]`` (iteration ``i``'s global arrays) sliced to the rank's
    rows.  ``start_step`` 1 starts where G's update is taken.  ``cfg_fields``:
    trainer config fields to set (``remat``, ``opt_state_dtype``).  Returns
    the full state (JAX layout), each iteration's metrics and the shapes
    this rank stores."""
    mesh = _mesh(model)
    k, batch = real.shape[0], real.shape[1]
    if flavor == "gan":
        gen_fn, disc_fn, cfg, gen, disc = _mnist_trainer_parts(mode, params, batch, k)
        cls = GanTrainer
    else:
        gen_fn, disc_fn, cfg, gen, disc = _flagship_parts(params, batch, k)
        cls = AcganTrainer
    cfg = dataclasses.replace(cfg, **(cfg_fields or {}))
    if mesh is None:
        trainer, specs = cls(gen_fn, disc_fn, cfg), None
        state = trainer.init_state(gen, disc)
        rank, world = 0, 1
    else:
        trainer, state, specs = data_parallel(mesh, cls, gen_fn, disc_fn, cfg, gen, disc)
        rank, world = mesh.rank, mesh.world
    batches = [torch.from_numpy(real)] + ([] if labels is None else [torch.from_numpy(labels)])
    if mesh is not None:
        batches = [local_rows(mesh, b, 1) for b in batches]
    metrics = []
    state.step = start_step
    for i in range(iters):
        rand = (Randomness(seed, "cpu", rank=rank, world=world).for_step(state.step) if draws is None
                else SlicedDraws(draws[i], rank, world))
        out = trainer.step(state, *batches, rand)
        metrics.append({m: float(v) for m, v in out.items()})
        if draws is not None:
            assert rand.exhausted()
    return _report(state, mesh, specs, metrics)


def spmd_steps(flavor: str, params: dict, real: np.ndarray, labels: np.ndarray | None = None, *,
               model: int = 2, iters: int = 2, seed: int = 3, draws: list | None = None,
               start_step: int = 0) -> dict:
    """``iters`` iterations of ``parallel.make_spmd_trainer`` (per-device
    semantics, ghost batch norm) on the global stack; every rank draws
    ``draws[i]`` at iteration ``i`` (the same local arrays on each) or the
    port's own per-device draws."""
    mesh = _mesh(model)
    k, batch = real.shape[0], real.shape[1]
    if flavor == "gan":
        gen_fn, disc_fn, cfg, gen, disc = _mnist_trainer_parts("wgan-CT", params, batch, k)
    else:
        gen_fn, disc_fn, cfg, gen, disc = _flagship_parts(params, batch, k)
    state, step, specs = make_spmd_trainer(gen_fn, disc_fn, cfg, mesh, gen, disc, flavor=flavor)
    state.step = start_step
    batches = [torch.from_numpy(real)] + ([] if labels is None else [torch.from_numpy(labels)])
    metrics = []
    for i in range(iters):
        rand = Randomness(seed, "cpu").for_step(i) if draws is None else SlicedDraws(draws[i])
        state, out = step(state, *batches, rand)
        metrics.append({m: float(v) for m, v in out.items()})
    return _report(state, mesh, specs, metrics)


# ------------------------------------------------------------------ the apps

def small_flagship_data() -> None:
    """The synthetic CIFAR-10 at 256 training and 256 test images (the
    full draw takes seconds a process)."""
    from ctgan_tpu_torch.data import cifar10, synthetic

    cifar10._synthetic = lambda: synthetic.synthetic_cifar10(n_train=256, n_test=256)


def flagship_main(cfg: dict) -> dict:
    """The flagship app's ``main`` on the CPU with ``cfg`` (the app's
    ``Config`` fields), on the small synthetic set; returns the records this
    process logged and the shapes of G's leaves it stores (its checkpoints
    hold the full state)."""
    from ctgan_tpu_torch.apps import ct_gan_cifar_resnet as app

    small_flagship_data()
    state, records = app.main(cfg=app.Config(**cfg), device="cpu")
    return {"records": records, "stored": {k: tuple(v.shape) for k, v in state.gen_params.items()}}


def generate_main(cfg: dict) -> dict:
    """``apps.generate.main`` on the CPU with ``cfg``; returns its samples."""
    from ctgan_tpu_torch.apps import generate

    return {"samples": generate.main(cfg=generate.Config(**cfg), device="cpu")}



def generate_refusal(cfg: dict) -> str:
    """What ``apps.generate.main`` exits with on ``cfg`` over the group."""
    from ctgan_tpu_torch.apps import generate

    try:
        generate.main(cfg=generate.Config(**cfg), device="cpu")
    except SystemExit as exc:
        return str(exc)
    return ""


def chip_lockstep(iters: int = 2) -> dict:
    """``chip_smoke.py``'s ``_lockstep_mesh`` (the ``dp_two_ranks`` and
    ``dp_world1`` check) on the CPU over the group, at dim 16 on a small
    synthetic set: its report on this rank."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    chip_smoke.DP_SYNTHETIC = (256, 256)
    mesh = _mesh(1)
    cfg = chip_smoke.app.Config(DIM_G=16, DIM_D=16, BATCH_SIZE=4, N_CRITIC=2)
    with chip_smoke._small_synthetic():
        plain, meshed = chip_smoke.app.setup(cfg, "cpu"), chip_smoke.app.setup(cfg, "cpu", mesh)
    return chip_smoke._lockstep_mesh("cpu", plain, meshed, state_to_jax(plain.state), iters=iters, what="cpu",
                                     check=False)
