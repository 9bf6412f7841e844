"""MNIST (counterpart of ``ctgan_tpu/data/mnist.py``).

Reads ``mnist.pkl.gz`` (the classic three-split pickle) from the first of
the JAX package's three places that holds it: ``path``,
``/tmp/mnist.pkl.gz``, ``~/data/mnist.pkl.gz``.  Otherwise the
deterministic synthetic set of ``data.synthetic.synthetic_mnist``:
50,000 / 10,000 / 10,000 images.  Images are flat ``[N, 784]`` float32 in
[0, 1], labels int64.  The synthetic draw takes a second or two, so a
process makes it once and hands out copies.
"""

from __future__ import annotations

import functools
import gzip
import os
import pickle

import numpy as np

from .iterator import epoch_batches
from .synthetic import synthetic_mnist

__all__ = ["load", "load_arrays"]


@functools.lru_cache(maxsize=1)
def _synthetic():
    return synthetic_mnist()


def load_arrays(path: str | None = None, n_examples: int | None = None) -> dict:
    """``{"train": (images, labels), "dev": ..., "test": ...}``; the train
    split cut to its first ``n_examples``."""
    candidates = [path, "/tmp/mnist.pkl.gz", os.path.expanduser("~/data/mnist.pkl.gz")]
    filepath = next((p for p in candidates if p and os.path.exists(p)), None)
    if filepath:
        with gzip.open(filepath, "rb") as f:
            splits = pickle.load(f, encoding="latin1")
        splits = [(np.asarray(x, "float32"), np.asarray(y, "int64")) for x, y in splits]
    else:
        splits = [tuple(a.copy() for a in split) for split in _synthetic()]
    train, dev, test = splits
    if n_examples is not None:
        train = (train[0][:n_examples], train[1][:n_examples])
    return {"train": train, "dev": dev, "test": test}


def load(batch_size: int, test_batch_size: int | None = None, n_examples: int | None = None,
         path: str | None = None, seed: int = 0):
    """``(train_gen, dev_gen, test_gen)``: factories of one epoch's
    shuffled ``(images, labels)`` batches each (``tflib/mnist.py:100-104``),
    drawn with seeds ``seed``, ``seed + 1`` and ``seed + 2``."""
    test_batch_size = test_batch_size or batch_size
    d = load_arrays(path, n_examples)
    return (epoch_batches(list(d["train"]), batch_size, seed),
            epoch_batches(list(d["dev"]), test_batch_size, seed + 1),
            epoch_batches(list(d["test"]), test_batch_size, seed + 2))
