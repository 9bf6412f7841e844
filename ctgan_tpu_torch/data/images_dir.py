"""Directory-of-images input (own copy of ``ctgan_tpu/data/images_dir.py``,
which its package cannot import without JAX).

Host-side: shuffled ``[B, 3, size, size]`` uint8 batches of the PNG and JPEG
files of a directory, decoded with PIL, each image flipped left to right
with probability 1/2; or, when the directory is missing or holds no image,
of the synthetic set.  Every draw comes from one ``default_rng(seed)`` in
the JAX package's order, so both give the same batches.  ``prefetch`` runs
a generator in a background thread; an error there (PIL missing, say) is
raised to the consumer, not turned into the end of the stream.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator

import numpy as np

from .synthetic import synthetic_images

__all__ = ["fake_image_generator", "image_dir_generator", "prefetch"]


def _list_images(data_dir: str) -> list[str]:
    exts = (".png", ".jpg", ".jpeg")
    return sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir) if f.lower().endswith(exts))


def _decode(path: str, size: int) -> np.ndarray:
    """A ``[3, size, size]`` uint8 image, RGB, resized (PIL's default
    filter) when it is not ``size`` square."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if img.size != (size, size):
        img = img.resize((size, size))
    return np.asarray(img, dtype="uint8").transpose(2, 0, 1)


def image_dir_generator(
    data_dir: str | None,
    batch_size: int,
    size: int = 64,
    *,
    random_flip: bool = True,
    seed: int = 0,
    synthetic_n: int = 4096,
) -> Iterator[np.ndarray]:
    """Endless epochs of shuffled ``[B, 3, size, size]`` uint8 batches
    (drop-last).  Falls back to ``synthetic_images(synthetic_n, 3, size,
    seed=seed)`` when ``data_dir`` is not given, is not a directory or holds
    no image, as the JAX package does."""
    rng = np.random.default_rng(seed)
    files = _list_images(data_dir) if data_dir and os.path.isdir(data_dir) else None
    if not files:
        flat, _ = synthetic_images(synthetic_n, 3, size, seed=seed)
        data = flat.reshape(-1, 3, size, size)
        while True:
            idx = rng.permutation(len(data))
            for i in range(0, len(data) - batch_size + 1, batch_size):
                batch = data[idx[i:i + batch_size]].copy()
                if random_flip:
                    flips = rng.random(batch_size) > 0.5
                    batch[flips] = batch[flips, :, :, ::-1]
                yield batch
    else:
        while True:
            order = rng.permutation(len(files))
            batch = []
            for j in order:
                batch.append(_decode(files[j], size))
                if len(batch) == batch_size:
                    arr = np.stack(batch)
                    if random_flip:
                        flips = rng.random(batch_size) > 0.5
                        arr[flips] = arr[flips, :, :, ::-1]
                    yield arr
                    batch = []


def fake_image_generator(batch_size: int, size: int = 256, n_unique: int = 2, seed: int = 7) -> Iterator[np.ndarray]:
    """The same ``n_unique`` synthetic images, tiled to a batch, forever
    (the reference's ``lsun256_test.py:5-18`` mock)."""
    flat, _ = synthetic_images(n_unique, 3, size, seed=seed)
    data = flat.reshape(-1, 3, size, size)
    tiled = np.tile(data, (max(1, batch_size // n_unique + 1), 1, 1, 1))[:batch_size]
    while True:
        yield tiled.copy()


class _Raised:
    def __init__(self, error: BaseException):
        self.error = error


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """The items of ``it``, made up to ``depth`` ahead in a daemon thread,
    so host decoding overlaps the device's step.  An exception in the thread
    is raised here when its turn comes."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()

    def worker():
        last = end
        try:
            for item in it:
                q.put(item)
        except Exception as e:  # the consumer re-raises it
            last = _Raised(e)
        finally:
            q.put(last)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, _Raised):
            raise item.error
        yield item
