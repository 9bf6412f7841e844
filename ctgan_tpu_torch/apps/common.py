"""Shared app plumbing (counterpart of ``ctgan_tpu/apps/common.py``):
dataclass configs as command lines, the output directory, sample grids,
the choice of IS/FID scorer, the host input paths of the image apps, and
the train loop of the unconditional GAN apps."""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ..core import print_model_settings
from ..eval import TrainedScorer
from ..utils.images import save_images

__all__ = [
    "HostFeed", "dir_feed", "find_inception_file", "gan_step_fn", "native_feed", "parse_config", "pick_scorer",
    "require_device", "run_gan_loop", "save_sample_grid", "setup_out_dir",
]

# where the JAX package looks for the Inception-2015 frozen graph, in its
# order (ctgan_tpu/eval/inception2015.py:34-39); the last two are relative
# to the working directory
_INCEPTION_LOCATIONS = (
    "/tmp/imagenet/classify_image_graph_def.pb",
    "/tmp/imagenet/inception-2015-12-05.tgz",
    "weights/classify_image_graph_def.pb",
    "weights/inception-2015-12-05.tgz",
)


def parse_config(cls, argv=None):
    """An instance of the dataclass ``cls`` from ``--FIELD value`` flags;
    booleans take 1/true/yes."""
    parser = argparse.ArgumentParser(description=cls.__doc__)
    for f in dataclasses.fields(cls):
        if f.type in ("bool", bool):
            parser.add_argument("--" + f.name, default=f.default,
                                type=lambda s: s.lower() in ("1", "true", "yes"))
        else:
            parser.add_argument("--" + f.name, type=type(f.default), default=f.default)
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


def find_inception_file() -> str | None:
    """The Inception-2015 weight file that the JAX package would use:
    ``$CTGAN_INCEPTION_PB``, else the first of its four default locations
    that exists."""
    cands = [os.environ.get("CTGAN_INCEPTION_PB"), *_INCEPTION_LOCATIONS]
    return next((c for c in cands if c and os.path.exists(c)), None)


def pick_scorer(channels: int, size: int, out_dir: str, train_data=None, device="cuda"):
    """The IS/FID scorer: the TrainedScorer cached at
    ``<out_dir>/scorer.npz``, fitted on ``train_data`` (3 epochs) when the
    cache is missing.  Where the JAX package would find an Inception-2015
    weight file and score with that network, this raises: the port has no
    Inception-2015 scorer yet, and scoring with another net would give
    numbers that look comparable and are not."""
    path = find_inception_file()
    if path is not None:
        raise NotImplementedError(
            f"an Inception-2015 weight file is present ({path}), but the Inception-2015 scorer "
            "is not ported yet (ROADMAP Queue 1 item 11b); unset "
            "$CTGAN_INCEPTION_PB or move the file to score with the TrainedScorer")
    scorer = TrainedScorer(channels, size, cache_path=f"{out_dir}/scorer.npz", device=device)
    if scorer.params is None and train_data is not None:
        print("IS scorer: training self-contained classifier scorer "
              "(not comparable with Inception-2015 scores)")
        t0 = time.perf_counter()
        acc = scorer.fit(train_data[0], train_data[1], epochs=3)
        print(f"IS scorer: fitted in {time.perf_counter() - t0:.3f} s, last batch accuracy {acc:.3f}")
    return scorer


def require_device(device) -> "torch.device":
    """``device`` as a ``torch.device``; a CUDA device must be present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


class HostFeed:
    """``[K, B, C*H*W]`` float32 reals in [-1, 1] on ``device`` from a host
    source, one stack per call: the image-directory path or the native
    pipeline of the JAX apps (``ctgan_tpu/apps/ct_gan_64x64.py:154-180``).
    A uint8 stack is scaled by ``2 * (x / 255 - 0.5)`` on the device, the
    JAX apps' host math in fp32.  ``close`` releases the source."""

    def __init__(self, next_stack, device, close=None):
        self._next, self.device, self._close = next_stack, device, close

    def __call__(self) -> torch.Tensor:
        x = self._next().to(self.device, non_blocking=True)
        return 2.0 * (x.float() / 255.0 - 0.5) if x.dtype == torch.uint8 else x

    def close(self) -> None:
        if self._close is not None:
            self._close()


def dir_feed(data_dir: str, batch_size: int, critic_iters: int, size: int, seed: int, device) -> HostFeed:
    """The images of ``data_dir`` (or, when it is empty or missing, the
    synthetic set) as ``data.images_dir`` reads them, ``critic_iters``
    batches to a stack, decoded in a background thread."""
    from ..data import images_dir, stack_batches

    batches = images_dir.prefetch(stack_batches(
        images_dir.image_dir_generator(data_dir or None, batch_size, size, seed=seed), critic_iters))
    return HostFeed(lambda: torch.from_numpy(next(batches)).reshape(critic_iters, batch_size, -1), device)


def native_feed(pipe, device) -> HostFeed:
    """The ``[K, B, D]`` float32 stacks of a ``data.native.NativePipeline``
    (flips and ``x * 2 / 255 - 1`` made by its worker threads)."""
    return HostFeed(lambda: torch.from_numpy(pipe.next()[0]), device, pipe.close)


def gan_step_fn(app, chw: tuple[int, int, int]):
    """``step_fn(state, rand)`` of the image GAN apps for the train loop:
    the real stack (the state's step's batch of ``app.sampler``'s pool,
    scaled and flipped, or ``app.feed``'s next), then one iteration of
    ``app.trainer``, every draw from ``rand.for_step(state.step)``."""
    from ..data import scale_and_flip

    def step_fn(state, rand):
        rand = rand.for_step(state.step)
        if app.feed is not None:
            real = app.feed()
        else:
            raw = app.sampler.sample(state.step)
            real = scale_and_flip(raw, rand.flip(raw.shape[0] * raw.shape[1]), chw)
        return state, app.trainer.step(state, real, rand)

    return step_fn


def run_gan_loop(cfg, state, step_fn, rand, test_fn, out_dir: str, device, *, print_std: bool = False):
    """The JAX GAN apps' ``train_loop`` call for a ``GanState``: to
    ``cfg.ITERS`` at their cadence (print every 100, test every
    ``sample_every``, save every ``save_every`` into ``<out_dir>/ckpt``),
    the iteration count as ``data_state``, checkpoints in the JAX layout,
    resuming from ``out_dir``.  ``step_fn(state, rand)`` draws its own
    batch.  Returns the final state and the records printed by this
    process.  ``print_std`` prints each metric's spread beside its mean, as
    the LSUN app's logger does."""
    from ..bridge import state_from_jax, state_to_jax
    from ..train import GanState, LoopConfig, train_loop
    from ..utils.logging import MetricLogger

    counter = {"i": 0}

    def next_batch():
        counter["i"] += 1
        return ()

    lcfg = LoopConfig(
        iters=cfg.ITERS, print_every=100, test_every=cfg.sample_every, save_every=cfg.save_every,
        ckpt_dir=f"{out_dir}/ckpt", allow_fresh_start=cfg.allow_fresh_start,
    )
    logger = MetricLogger(out_dir, print_std=print_std)
    state = train_loop(
        state, step_fn, next_batch, rand, lcfg, logger=logger, test_fn=test_fn,
        data_state=lambda: {"i": counter["i"]},
        set_data_state=lambda s: counter.update(i=int(s["i"])),
        to_blob=state_to_jax, from_blob=lambda blob: state_from_jax(blob, device, GanState),
    )
    return state, logger.records
