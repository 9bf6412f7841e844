"""Shared app plumbing (counterpart of ``ctgan_tpu/apps/common.py``):
dataclass configs as command lines, the output directory, sample grids and
the choice of IS/FID scorer."""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

from ..core import print_model_settings
from ..eval import TrainedScorer
from ..utils.images import save_images

__all__ = ["parse_config", "setup_out_dir", "save_sample_grid", "pick_scorer", "find_inception_file"]

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
