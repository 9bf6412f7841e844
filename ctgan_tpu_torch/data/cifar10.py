"""CIFAR-10 training split (counterpart of ``ctgan_tpu/data/cifar10.py``).

Reads the python-version batch files when ``data_dir`` holds them, else
makes the deterministic synthetic set.  Flat ``[N, 3072]`` uint8 in
channel-major (C, H, W) order, and int64 labels.  Only the training split is
loaded: the test split serves the evaluation, which is not ported yet.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from .synthetic import synthetic_images

__all__ = ["load_train"]

N_TRAIN = 50000
SYNTHETIC_SEED = 4321  # the JAX package's synthetic_cifar10 train split


def _unpickle(path):
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="latin1")
    return np.asarray(d["data"], "uint8"), np.asarray(d["labels"], "int64")


def load_train(data_dir: str | None = None, n_examples: int | None = None):
    """``(images, labels)`` of the first ``n_examples`` training examples.

    Without data files the synthetic set is drawn at ``n_examples`` (equal
    to the JAX package's synthetic training split at the full 50000; a
    smaller draw is a different, cheaper set)."""
    n = N_TRAIN if n_examples is None else n_examples
    if data_dir and os.path.exists(os.path.join(data_dir, "data_batch_1")):
        parts = [_unpickle(os.path.join(data_dir, f"data_batch_{i}")) for i in range(1, 6)]
        images = np.concatenate([x for x, _ in parts])
        labels = np.concatenate([y for _, y in parts])
        return images[:n], labels[:n]
    return synthetic_images(n, 3, 32, seed=SYNTHETIC_SEED)
