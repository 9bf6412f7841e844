"""Deterministic synthetic images (own copy of ``ctgan_tpu/data/synthetic.py``,
which cannot be imported without JAX).

Each class is a distinct mixture of spatial gaussian blobs plus noise, so a
discriminator has real signal to learn.  The arrays equal the JAX package's
for the same arguments.  The noise is drawn and added in chunks of rows:
the generator's stream is the same as one whole draw, and the host memory
needed is a chunk's, not the whole set's in float64.
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_cifar10", "synthetic_images", "synthetic_mnist"]

_CHUNK = 4096


def synthetic_images(
    n: int,
    channels: int,
    size: int,
    n_classes: int = 10,
    seed: int = 1234,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (uint8 images [N, C*H*W] flat C-major, int labels [N]).

    Each class c gets k class-specific blob centers; images are blob mixtures
    plus noise: cheap, deterministic, and classifiable.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n).astype("int64")
    yy, xx = np.mgrid[0:size, 0:size].astype("float32") / size
    # Class prototypes are seeded by the dataset *shape* only, so different
    # splits (different sampling seeds) share the same class definitions.
    proto_rng = np.random.default_rng((n_classes, channels, size))
    centers = proto_rng.uniform(0.15, 0.85, size=(n_classes, 3, 2)).astype("float32")
    widths = proto_rng.uniform(0.05, 0.15, size=(n_classes, 3)).astype("float32")
    base = np.zeros((n_classes, size, size), dtype="float32")
    for c in range(n_classes):
        for b in range(3):
            cy, cx = centers[c, b]
            base[c] += np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * widths[c, b] ** 2)
            )
    base /= base.max(axis=(1, 2), keepdims=True)
    tint = None
    if channels == 3:
        tint = proto_rng.uniform(0.5, 1.0, size=(n_classes, 3, 1, 1)).astype("float32")
    flat = np.empty((n, channels * size * size), dtype="uint8")
    for lo in range(0, n, _CHUNK):
        lab = labels[lo:lo + _CHUNK]
        imgs = base[lab][:, None, :, :].repeat(channels, axis=1)  # [n, C, H, W]
        if tint is not None:
            imgs = imgs * tint[lab]
        noise = rng.normal(0, 0.08, size=imgs.shape).astype("float32")
        imgs = np.clip(imgs + noise, 0.0, 1.0)
        flat[lo:lo + _CHUNK] = (imgs * 255).astype("uint8").reshape(len(lab), -1)
    return flat, labels


def synthetic_mnist(n_train: int = 50000, n_valid: int = 10000, n_test: int = 10000, seed: int = 1234):
    """``(train_x, train_y), (valid_x, valid_y), (test_x, test_y)``: flat
    ``[N, 784]`` float32 in [0, 1], the ``mnist.pkl.gz`` format, the JAX
    package's draw (``ctgan_tpu/data/synthetic.py:57-65``)."""
    out = []
    for i, n in enumerate((n_train, n_valid, n_test)):
        flat, labels = synthetic_images(n, 1, 28, seed=seed + i)
        out.append((flat.astype("float32") / 255.0, labels))
    return tuple(out)


def synthetic_cifar10(n_train: int = 50000, n_test: int = 10000, seed: int = 4321):
    """``(train_x, train_y), (test_x, test_y)``: flat ``[N, 3072]`` uint8
    in the cifar-10-batches-py value layout, the JAX package's draw."""
    return (synthetic_images(n_train, 3, 32, seed=seed),
            synthetic_images(n_test, 3, 32, seed=seed + 1))
