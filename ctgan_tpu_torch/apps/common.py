"""Shared app plumbing (counterpart of ``ctgan_tpu/apps/common.py``):
dataclass configs as command lines, the output directory, sample grids,
the choice of IS/FID scorer, the host input paths of the image apps, the
train loop of the unconditional GAN apps, and the process grid of a run
under ``torchrun`` (:func:`maybe_mesh`)."""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ..core import print_model_settings
from ..eval import Inception2015, TrainedScorer, find_inception_file
from ..utils.images import save_images

__all__ = [
    "HostFeed", "dir_feed", "find_inception_file", "gan_batches", "gan_step_fn", "maybe_mesh", "native_feed",
    "parse_config", "pick_scorer",
    "require_device", "run_gan_loop", "save_sample_grid", "setup_out_dir",
]


# a field's other flag: the JAX apps' name of the mask kernel's switch
# (docs/MIGRATION.md's performance knobs)
FLAG_ALIASES = {"CUDA_DROPOUT": "PALLAS_DROPOUT"}


def parse_config(cls, argv=None):
    """An instance of the dataclass ``cls`` from ``--FIELD value`` flags
    (``--PALLAS_DROPOUT`` sets ``CUDA_DROPOUT``); booleans take
    1/true/yes."""
    parser = argparse.ArgumentParser(description=cls.__doc__)
    for f in dataclasses.fields(cls):
        flags = ["--" + f.name] + (["--" + FLAG_ALIASES[f.name]] if f.name in FLAG_ALIASES else [])
        if f.type in ("bool", bool):
            parser.add_argument(*flags, default=f.default, type=lambda s: s.lower() in ("1", "true", "yes"))
        else:
            parser.add_argument(*flags, type=type(f.default), default=f.default)
    return cls(**vars(parser.parse_args(argv)))


def setup_out_dir(cfg) -> str:
    """Create ``cfg.out_dir`` and print the config's settings."""
    out = getattr(cfg, "out_dir", "runs/default")
    os.makedirs(out, exist_ok=True)
    print_model_settings({k.upper(): v for k, v in dataclasses.asdict(cfg).items()})
    return out


def save_sample_grid(samples_flat, shape_chw, path, value_range=(-1.0, 1.0)) -> None:
    """Flat C-major samples (array or tensor) -> a PNG grid, rescaled from
    ``value_range`` to [0, 1]."""
    if hasattr(samples_flat, "detach"):
        samples_flat = samples_flat.detach().float().cpu().numpy()
    lo, hi = value_range
    x = (np.asarray(samples_flat, dtype="float32") - lo) / (hi - lo)
    c, h, w = shape_chw
    imgs = x.reshape(-1, c, h, w)
    if c == 1:
        imgs = imgs[:, 0]
    save_images(imgs, path)


class _FlatInception:
    """:class:`Inception2015` over the apps' flat ``[N, C*H*W]`` C-major
    0..255-valued samples (arrays or tensors), 1-channel images repeated to
    3 (``ctgan_tpu/apps/common.py:23-45``)."""

    comparable = True  # comparable with the reference's inception scores

    def __init__(self, inc: Inception2015, channels: int, size: int):
        self._inc = inc
        self._shape = (channels, size, size)

    def _unflatten(self, images) -> torch.Tensor:
        x = images if isinstance(images, torch.Tensor) else torch.from_numpy(np.asarray(images))
        x = x.to(self._inc.device, torch.float32).reshape(-1, *self._shape)
        return x.repeat(1, 3, 1, 1) if self._shape[0] == 1 else x

    def inception_score(self, images, splits: int = 10):
        return self._inc.inception_score(self._unflatten(images), splits=splits)

    def fid(self, real_images, fake_images):
        return self._inc.fid(self._unflatten(real_images), self._unflatten(fake_images))


def pick_scorer(channels: int, size: int, out_dir: str, train_data=None, device="cuda"):
    """The IS/FID scorer on ``device``, as the JAX package picks it: the
    Inception-2015 scorer (``comparable`` True) when a weight file is found
    (``$CTGAN_INCEPTION_PB``, ``/tmp/imagenet/`` or ``weights/``, see
    ``eval.inception2015``), else the TrainedScorer cached at
    ``<out_dir>/scorer.npz`` (``comparable`` False), fitted on
    ``train_data`` (3 epochs) when the cache is missing.  A weight file that
    does not load raises: nothing falls back to the TrainedScorer."""
    path = find_inception_file()
    if path is not None:
        print(f"IS scorer: Inception-2015 frozen graph from {path} "
              "(scores comparable to the reference)")
        return _FlatInception(Inception2015(path, device=device), channels, size)
    scorer = TrainedScorer(channels, size, cache_path=f"{out_dir}/scorer.npz", device=device)
    if scorer.params is None and train_data is not None:
        print("IS scorer: training self-contained classifier scorer "
              "(supply $CTGAN_INCEPTION_PB for reference-comparable scores)")
        t0 = time.perf_counter()
        acc = scorer.fit(train_data[0], train_data[1], epochs=3)
        print(f"IS scorer: fitted in {time.perf_counter() - t0:.3f} s, last batch accuracy {acc:.3f}")
    return scorer


def maybe_mesh(n_devices: int | None = None, model_axis: int = 1, device="cuda"):
    """The run's ``data x model`` process grid (``parallel.make_mesh``) when
    it runs as more than one process, else None, as the JAX package's
    ``maybe_mesh`` returns None for one device
    (``ctgan_tpu/apps/common.py:113-134``).

    The processes are torchrun's: ``WORLD_SIZE``, ``RANK`` and
    ``LOCAL_RANK`` say how many and which.  Unless a process group is
    initialised already, this initialises one: NCCL on ``cuda:LOCAL_RANK``
    for a CUDA ``device``, gloo for the CPU; a failed initialisation, or a
    rank without its GPU, raises.  A process group its caller initialised
    is used as it is, whatever its size (one process too: the mesh path
    with its collectives).  ``n_devices``, when given, must be the number
    of processes."""
    import torch.distributed as dist

    from ..parallel import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", "1"))
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the run has {world} processes (one device each)")
    if world <= 1 and not dist.is_initialized():
        return None
    if world < model_axis:
        raise ValueError(f"model_axis={model_axis} needs at least that many devices; "
                         f"only {world} available (of {world} total)")
    if world % model_axis:
        raise ValueError(f"model_axis={model_axis} does not divide the {world} processes")
    device = torch.device(device)
    if dist.is_initialized():
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        return make_mesh(data=world // model_axis, model=model_axis, device=device)
    rank, local = int(os.environ["RANK"]), int(os.environ.get("LOCAL_RANK", "0"))
    if device.type == "cuda":
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} (LOCAL_RANK {local}) sees {torch.cuda.device_count()} GPUs: a CUDA "
                               "run needs one GPU per process on each node")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", rank=rank, world_size=world, device_id=device)
    else:
        dist.init_process_group("gloo", rank=rank, world_size=world)
    return make_mesh(data=world // model_axis, model=model_axis, device=device)


def is_main(mesh) -> bool:
    """Whether this process logs, prints and writes: rank 0, or the only one."""
    return mesh is None or mesh.rank == 0


def require_device(device) -> "torch.device":
    """``device`` as a ``torch.device``; a CUDA device must be present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


class HostFeed:
    """``[K, B, C*H*W]`` host stacks from a host source, one per step: the
    image-directory path or the native pipeline of the JAX apps
    (``ctgan_tpu/apps/ct_gan_64x64.py:154-180``).  ``next()`` gives the
    stack (uint8 or float32) as a step input, which reaches the step on the
    device (a captured step's static input buffer); :meth:`to_real` makes
    it float32 reals in [-1, 1] there.  ``close`` releases the source."""

    def __init__(self, next_stack, close=None):
        self.next, self._close = next_stack, close

    @staticmethod
    def to_real(x: torch.Tensor) -> torch.Tensor:
        """A stack as reals: uint8 scaled by ``2 * (x / 255 - 0.5)``, the
        JAX apps' host math in fp32; float32 as it is."""
        return 2.0 * (x.float() / 255.0 - 0.5) if x.dtype == torch.uint8 else x

    def close(self) -> None:
        if self._close is not None:
            self._close()


def dir_feed(data_dir: str, batch_size: int, critic_iters: int, size: int, seed: int) -> HostFeed:
    """The images of ``data_dir`` (or, when it is empty or missing, the
    synthetic set) as ``data.images_dir`` reads them, ``critic_iters``
    batches to a stack, decoded in a background thread."""
    from ..data import images_dir, stack_batches

    batches = images_dir.prefetch(stack_batches(
        images_dir.image_dir_generator(data_dir or None, batch_size, size, seed=seed), critic_iters))
    return HostFeed(lambda: torch.from_numpy(next(batches)).reshape(critic_iters, batch_size, -1))


def native_feed(pipe) -> HostFeed:
    """The ``[K, B, D]`` float32 stacks of a ``data.native.NativePipeline``
    (flips and ``x * 2 / 255 - 1`` made by its worker threads)."""
    return HostFeed(lambda: torch.from_numpy(pipe.next()[0]), pipe.close)


def gan_batches(app):
    """``batch(i)`` -> the step inputs of iteration ``i`` of a GAN app:
    ``(app.feed.next(),)``, a host stack, where the app has a feed, else
    ``(app.sampler.host_indices(i),)``, the ``K * B`` pool indices on the
    host."""
    feed = getattr(app, "feed", None)
    if feed is not None:
        return lambda i: (feed.next(),)
    return lambda i: (app.sampler.host_indices(i),)


def gan_step_fn(app, chw: tuple[int, int, int]):
    """``step_fn(state, batch, rand)`` of the image GAN apps for the train
    loop: the real stack (``batch`` of :func:`gan_batches`: indices into
    ``app.sampler``'s pool, gathered, scaled and flipped on the device, or
    ``app.feed``'s stack, scaled), then one iteration of ``app.trainer``,
    every draw from ``rand.for_step(state.step)``."""
    from ..data import scale_and_flip

    def step_fn(state, batch, rand):
        rand = rand.for_step(state.step)
        if app.feed is not None:
            real = HostFeed.to_real(batch)
        else:
            raw = app.sampler.gather(batch)
            real = scale_and_flip(raw, rand.flip(raw.shape[0] * raw.shape[1]), chw)
        return state, app.trainer.step(state, real, rand)

    return step_fn


def run_gan_loop(cfg, state, step_fn, batch, rand, test_fn, out_dir: str, device, *, print_std: bool = False,
                 mesh=None):
    """The JAX GAN apps' ``train_loop`` call for a ``GanState``: to
    ``cfg.ITERS`` at their cadence (print every 100, test every
    ``sample_every``, save every ``save_every`` into ``<out_dir>/ckpt``),
    the iteration count as ``data_state``, checkpoints in the JAX layout,
    resuming from ``out_dir``.  ``step_fn(state, *batch(i), rand)`` runs
    iteration ``i`` (``batch``: :func:`gan_batches`).  Returns the final
    state and the records printed by this process.  ``print_std`` prints
    each metric's spread beside its mean, as the LSUN app's logger does.
    Over a ``mesh`` of processes only rank 0 logs and writes (``train_loop``);
    ``state`` is then replicated (no model-sharded leaves)."""
    from ..bridge import state_from_jax, state_to_jax
    from ..train import GanState, LoopConfig, train_loop
    from ..utils.logging import MetricLogger

    counter = {"i": 0}

    def next_batch():
        i = counter["i"]
        counter["i"] += 1
        return batch(i)

    lcfg = LoopConfig(
        iters=cfg.ITERS, print_every=100, test_every=cfg.sample_every, save_every=cfg.save_every,
        ckpt_dir=f"{out_dir}/ckpt", allow_fresh_start=cfg.allow_fresh_start,
    )
    main = is_main(mesh)
    logger = MetricLogger(out_dir, print_std=print_std, quiet=not main)
    state = train_loop(
        state, step_fn, next_batch, rand, lcfg, logger=logger, test_fn=test_fn,
        data_state=lambda: {"i": counter["i"]},
        set_data_state=lambda s: counter.update(i=int(s["i"])),
        to_blob=state_to_jax, from_blob=lambda blob: state_from_jax(blob, device, GanState), mesh=mesh,
    )
    return state, logger.records
