"""Auxiliary dataset loaders (own copy of ``ctgan_tpu/data/aux_loaders.py``,
the reference's loader collection: ``svhn.py``, ``enwik8.py``,
``mnist_256.py``, ``mnist_binarized.py``, ``small_imagenet_32.py``,
``lsun256.py``/``lsun256_test.py``, ``imagenet_convert.py``,
``audio_dataset.py``).

Host loaders: each returns a factory of epoch generators of NumPy batches,
reading real files when present and drawing deterministic synthetic data
otherwise.  Every draw is taken in the JAX package's order, so a generator
yields the JAX package's arrays for the same arguments.  A factory keeps its
iterator between calls, so a second call yields the next epoch; the
binarised MNIST factory instead re-binarises per call and starts a fresh
iterator with the same seed (its batches come in the same order every
epoch).  No app of the port calls them.
"""

from __future__ import annotations

import os

import numpy as np

from .images_dir import fake_image_generator, image_dir_generator
from .iterator import EpochIterator
from .mnist import load_arrays as load_mnist_arrays
from .synthetic import synthetic_images

__all__ = [
    "svhn_generator",
    "enwik8_generator",
    "mnist_256_generator",
    "mnist_binarized_generator",
    "small_imagenet_32_generator",
    "lsun256_generator",
    "lsun256_test_generator",
    "convert_image_folder",
    "audio_generator",
]


def _epochs(it: EpochIterator):
    """A factory of generators, each the next ``batches_per_epoch`` batches
    of the one iterator ``it``."""

    def gen():
        for _ in range(it.batches_per_epoch()):
            yield next(it)

    return gen


def svhn_generator(batch_size: int, mat_path: str | None = None, seed: int = 0):
    """SVHN ``.mat`` loader (svhn.py): yields (uint8 flat ``[B, 3072]``
    C-major, labels mod 10).  Falls back to synthetic 32 px colour data."""
    if mat_path and os.path.exists(mat_path):
        from scipy.io import loadmat

        d = loadmat(mat_path)
        x = d["X"].transpose(3, 2, 0, 1).reshape(-1, 3072)  # HWCN -> NCHW flat
        y = d["y"].reshape(-1).astype("int64") % 10
    else:
        x, y = synthetic_images(4096, 3, 32, seed=seed)
    return _epochs(EpochIterator([x, y], batch_size, seed=seed))


def enwik8_generator(batch_size: int, seq_len: int, path: str | None = None, seed: int = 0):
    """Character-LM batching (enwik8.py:4-31): yields uint8 ``[B, seq_len]``
    windows over the byte stream (synthetic: 2^20 letters and spaces)."""
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            data = np.frombuffer(f.read(), np.uint8)
    else:
        rng = np.random.default_rng(seed)
        alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
        data = alphabet[rng.integers(0, len(alphabet), size=1 << 20)]
    n_windows = (len(data) - 1) // seq_len
    windows = data[: n_windows * seq_len].reshape(n_windows, seq_len)
    return _epochs(EpochIterator([windows], batch_size, seed=seed))


def mnist_256_generator(batch_size: int, seed: int = 0, n_examples: int | None = None):
    """MNIST quantised to 256 integer levels (mnist_256.py): yields
    (int32 ``[B, 784]`` in [0, 255], labels)."""
    d = load_mnist_arrays(n_examples=n_examples)
    x = (d["train"][0] * 255).astype("int32")
    return _epochs(EpochIterator([x, d["train"][1]], batch_size, seed=seed))


def mnist_binarized_generator(batch_size: int, seed: int = 0, n_examples: int | None = None):
    """Dynamically binarised MNIST (mnist_binarized.py): each call draws new
    Bernoulli(x) pixels from the one generator, then batches them with a
    fresh ``EpochIterator`` of the same ``seed``."""
    d = load_mnist_arrays(n_examples=n_examples)
    x, y = d["train"]
    rng = np.random.default_rng(seed)

    def gen():
        bern = (rng.random(x.shape) < x).astype("float32")
        it = EpochIterator([bern, y], batch_size, seed=seed)
        for _ in range(it.batches_per_epoch()):
            yield next(it)

    return gen


def small_imagenet_32_generator(batch_size: int, data_dir: str | None = None, seed: int = 0):
    """32 px small ImageNet (small_imagenet_32.py): a directory of images,
    or synthetic."""
    return image_dir_generator(data_dir, batch_size, size=32, seed=seed)


def lsun256_generator(batch_size: int, data_dir: str | None = None, seed: int = 0):
    """256 px LSUN (lsun256.py)."""
    return image_dir_generator(data_dir, batch_size, size=256, seed=seed)


def lsun256_test_generator(batch_size: int, seed: int = 7):
    """The reference's mock: the same two images forever
    (lsun256_test.py:5-18)."""
    return fake_image_generator(batch_size, size=256, n_unique=2, seed=seed)


def convert_image_folder(src_dir: str, dst_dir: str, size: int = 128) -> int:
    """Centre crop and resize (imagenet_convert.py): every ``.png``,
    ``.jpg`` or ``.jpeg`` of ``src_dir``, in name order, to a ``size`` x
    ``size`` RGB PNG ``<i>.png`` in ``dst_dir``.  Returns the count."""
    from PIL import Image

    os.makedirs(dst_dir, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(src_dir)):
        if not name.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        img = Image.open(os.path.join(src_dir, name)).convert("RGB")
        w, h = img.size
        side = min(w, h)
        left, top = (w - side) // 2, (h - side) // 2
        img = img.crop((left, top, left + side, top + side)).resize((size, size))
        img.save(os.path.join(dst_dir, f"{count}.png"))
        count += 1
    return count


def audio_generator(batch_size: int, seq_len: int = 16384, data_dir: str | None = None, seed: int = 0):
    """Audio batching (audio_dataset.py): yields float32 ``[B, seq_len]`` in
    [-1, 1], eight batches a call.  Decoding real audio needs a FLAC reader,
    so ``data_dir`` is not read: each clip is three random sinusoids at 16
    kHz plus Gaussian noise, drawn per clip in that order (frequencies,
    amplitudes, noise)."""
    rng = np.random.default_rng(seed)

    def gen():
        t = np.arange(seq_len) / 16000.0
        for _ in range(8):
            batch = []
            for _ in range(batch_size):
                f = rng.uniform(80, 2000, size=3)
                a = rng.uniform(0.1, 0.4, size=3)
                wave = sum(ai * np.sin(2 * np.pi * fi * t) for fi, ai in zip(f, a))
                wave += rng.normal(0, 0.05, size=seq_len)
                batch.append(np.clip(wave, -1, 1))
            yield np.asarray(batch, "float32")

    return gen
