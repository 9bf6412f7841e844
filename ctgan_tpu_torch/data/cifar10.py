"""CIFAR-10 (counterpart of ``load_arrays``, ``load`` and ``load_normalized``
in ``ctgan_tpu/data/cifar10.py:34-71``).

Reads the python-version batch files when ``data_dir`` holds them, else
makes the deterministic synthetic set.  Flat ``[N, 3072]`` uint8 in
channel-major (C, H, W) order, and int64 labels.  :func:`load_arrays`
returns the JAX package's exact train and test arrays: the synthetic set is
always drawn whole (50,000 train, 10,000 test) and the train split is then
cut to ``n_examples``, so a small run trains on the first images of the
full set and evaluates on the same test split.  The synthetic draw takes
seconds, so a process makes it once and hands out copies.
"""

from __future__ import annotations

import functools
import os
import pickle

import numpy as np

from .iterator import epoch_batches
from .synthetic import synthetic_cifar10

__all__ = ["load", "load_arrays", "load_normalized", "load_train"]


def _unpickle(path):
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="latin1")
    return np.asarray(d["data"], "uint8"), np.asarray(d["labels"], "int64")


@functools.lru_cache(maxsize=1)
def _synthetic():
    return synthetic_cifar10()


def load_arrays(data_dir: str | None = None, n_examples: int | None = None) -> dict:
    """``{"train": (images, labels), "test": (images, labels)}``."""
    if data_dir and os.path.exists(os.path.join(data_dir, "data_batch_1")):
        parts = [_unpickle(os.path.join(data_dir, f"data_batch_{i}")) for i in range(1, 6)]
        train = (np.concatenate([x for x, _ in parts]), np.concatenate([y for _, y in parts]))
        test = _unpickle(os.path.join(data_dir, "test_batch"))
    else:
        train, test = _synthetic()
    if n_examples is not None:
        train = (train[0][:n_examples], train[1][:n_examples])
    return {"train": tuple(a.copy() for a in train), "test": tuple(a.copy() for a in test)}


def load(batch_size: int, data_dir: str | None = None, n_examples: int | None = None, seed: int = 0):
    """``(train_gen, test_gen)``: factories of one epoch's shuffled
    ``(images, labels)`` batches each, drawn with seeds ``seed`` and
    ``seed + 1`` (``ctgan_tpu/data/cifar10.py:50-63``)."""
    d = load_arrays(data_dir, n_examples)
    return epoch_batches(list(d["train"]), batch_size, seed), epoch_batches(list(d["test"]), batch_size, seed + 1)


def load_train(data_dir: str | None = None, n_examples: int | None = None):
    """``(images, labels)`` of the first ``n_examples`` training examples."""
    return load_arrays(data_dir, n_examples)["train"]


def load_normalized(data_dir: str | None = None, subset: str = "train"):
    """``(images, labels)`` of the train (or, for any other ``subset``, the
    test) split as the semi-supervised apps read it: float32 NCHW in [-0.5,
    0.5] (``x / 255 - 0.5``; ``cifar10_data.py:30-44`` of the reference)."""
    imgs, labels = load_arrays(data_dir)["train" if subset == "train" else "test"]
    return imgs.reshape(-1, 3, 32, 32).astype("float32") / 255.0 - 0.5, labels
