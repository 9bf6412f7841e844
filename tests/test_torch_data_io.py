"""The image-directory reader and the native host pipeline of
``ctgan_tpu_torch`` (``data/images_dir.py``, ``data/native.py``,
``data/iterator.py::stack_batches``) against ``ctgan_tpu``'s on the CPU,
and the 64 px and 128 px apps on those input paths.

Every comparison is exact: both packages draw from the same
``default_rng`` streams, decode with the same PIL calls and run the same
C++ library (each builds its own copy of ``native/ctgan_io.cpp``).
"""

from __future__ import annotations

import math
import sys

import numpy as np
import pytest
import torch

from ctgan_tpu.data import images_dir as jax_images_dir
from ctgan_tpu.data import native as jax_native
from ctgan_tpu.data import stack_batches as jax_stack_batches

from ctgan_tpu_torch.apps import ct_gan_64x64 as app64
from ctgan_tpu_torch.apps import wgan_lsun128 as app128
from ctgan_tpu_torch.data import images_dir, native, stack_batches
from ctgan_tpu_torch.data.synthetic import synthetic_images
from ctgan_tpu_torch.models import lsun128

import torch_parity  # noqa: F401  (one intra-op thread per test worker)

TINY_LSUN = lsun128.Lsun128Config(dim_g_4=16, dim_g_8=8, dim_g_16=8, dim_g_32=8, dim_g_64=8, dim_d_64=8,
                                  dim_d_32=8, dim_d_16=8, dim_d_8=16)


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    """Seven RGB images, PNG and JPEG, some not 16 px square (resized on
    read), one RGBA, and a file that is no image."""
    from PIL import Image

    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    for i, (size, ext, mode) in enumerate([(16, "png", "RGB"), (20, "png", "RGB"), (16, "jpg", "RGB"),
                                           (12, "PNG", "RGB"), (16, "png", "RGBA"), (16, "jpeg", "RGB"),
                                           (17, "png", "RGB")]):
        pixels = rng.integers(0, 256, (size, size, len(mode)), dtype=np.uint8)
        Image.fromarray(pixels, mode).save(root / f"img{i}.{ext}")
    (root / "notes.txt").write_text("not an image")
    return root


def _take(gen, n):
    return [next(gen) for _ in range(n)]


def test_image_dir_batches_equal_jax(png_dir):
    """Three epochs of batches of 3 (drop-last) from the directory."""
    got = _take(images_dir.image_dir_generator(str(png_dir), 3, 16, seed=4), 6)
    want = _take(jax_images_dir.image_dir_generator(str(png_dir), 3, 16, seed=4), 6)
    for g, w in zip(got, want):
        assert g.shape == (3, 3, 16, 16) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], got[1])


@pytest.mark.parametrize("data_dir", [None, "missing", "empty"])
def test_synthetic_fallback_equals_jax(tmp_path, data_dir):
    """No directory, a missing one and one without images all give the
    synthetic set, shuffled and flipped as JAX's."""
    path = {"missing": str(tmp_path / "nope"), "empty": str(tmp_path), None: None}[data_dir]
    got = _take(images_dir.image_dir_generator(path, 4, 8, seed=2, synthetic_n=10), 5)
    want = _take(jax_images_dir.image_dir_generator(path, 4, 8, seed=2, synthetic_n=10), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_fake_generator_and_stack_batches_equal_jax():
    got = next(stack_batches(images_dir.fake_image_generator(5, 8, n_unique=2), 3))
    want = next(jax_stack_batches(jax_images_dir.fake_image_generator(5, 8, n_unique=2), 3))
    assert got.shape == (3, 5, 3, 8, 8)
    np.testing.assert_array_equal(got, want)
    pairs = iter([(np.full(2, i), np.full(1, -i)) for i in range(4)])
    a, b = next(stack_batches(pairs, 2))
    np.testing.assert_array_equal(a, [[0, 0], [1, 1]])
    np.testing.assert_array_equal(b, [[0], [-1]])


def test_prefetch_keeps_order_and_raises_the_workers_error():
    assert list(images_dir.prefetch(iter(range(7)), depth=2)) == list(range(7))

    def failing():
        yield 1
        raise ImportError("PIL is missing")

    gen = images_dir.prefetch(failing())
    assert next(gen) == 1
    with pytest.raises(ImportError, match="PIL"):
        next(gen)


def test_a_real_directory_without_pil_raises(png_dir, monkeypatch):
    """Where PIL is missing, a directory of images fails with an
    ImportError naming PIL; it does not fall back to the synthetic set."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    batches = images_dir.prefetch(images_dir.image_dir_generator(str(png_dir), 2, 16))
    with pytest.raises(ImportError, match="PIL"):
        next(batches)


# ------------------------------------------------------------------ native


def _idx_blob(arr: np.ndarray) -> bytes:
    header = bytes([0, 0, 8, arr.ndim]) + b"".join(int(d).to_bytes(4, "big") for d in arr.shape)
    return header + arr.astype(np.uint8).tobytes()


def test_native_library_builds_outside_native_dir():
    assert native.native_available(), native.build_error()
    path = native.library_path()
    assert path.is_file() and "build" in path.parts and path.parent.parent.name == "native"


def test_decoders_equal_jax():
    rng = np.random.default_rng(1)
    for arr in (rng.integers(0, 256, (5, 4, 3)), rng.integers(0, 10, (9,))):
        got, want = native.decode_idx(_idx_blob(arr)), jax_native.decode_idx(_idx_blob(arr))
        np.testing.assert_array_equal(got, arr)
        np.testing.assert_array_equal(got, want)
    raw = rng.integers(0, 256, (4, 3073), dtype=np.uint8).tobytes()
    (gi, gl), (wi, wl) = native.decode_cifar_bin(raw), jax_native.decode_cifar_bin(raw)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)
    assert gi.shape == (4, 3072) and gl.dtype == np.int64


def test_pipeline_batches_and_resume_equal_jax():
    """Five ``[K, B, D]`` stacks with flips and labels, across an epoch
    boundary; then both seek back to the second stack's cursor and give
    the same stacks again."""
    images, labels = synthetic_images(40, 3, 8, seed=3)
    kw = dict(chw=(3, 8, 8), flip=True, seed=9)
    ours, theirs = native.NativePipeline(images, labels, 4, 3, **kw), jax_native.NativePipeline(images, labels, 4, 3,
                                                                                               **kw)
    try:
        got, want, states = [], [], []
        for _ in range(5):
            states.append(ours.state())
            assert states[-1] == theirs.state()
            got.append(ours.next())
            want.append(theirs.next())
        for (gi, gl), (wi, wl) in zip(got, want):
            assert gi.shape == (3, 4, 192) and gi.dtype == np.float32 and gl.shape == (3, 4)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
        assert -1.0 <= got[0][0].min() and got[0][0].max() <= 1.0
        ours.set_state(states[1])
        again = [ours.next() for _ in range(2)]
        for (gi, gl), (wi, wl) in zip(again, got[1:3]):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    finally:
        ours.close()
        theirs.close()


def test_native_entry_points_raise_without_the_library(monkeypatch):
    """Without the library the decoders and the pipeline raise, naming
    why it is missing; there is no second path."""
    monkeypatch.setattr(native, "load_library", lambda: None)
    monkeypatch.setattr(native, "_error", "CalledProcessError: g++ failed")
    images, labels = synthetic_images(8, 3, 8, seed=3)
    for call in (lambda: native.decode_idx(_idx_blob(np.zeros((2, 3)))),
                 lambda: native.decode_cifar_bin(bytes(3073)),
                 lambda: native.NativePipeline(images, labels, 2)):
        with pytest.raises(RuntimeError, match="unavailable: CalledProcessError: g\\+\\+ failed"):
            call()


# ------------------------------------------------------------------ the apps on these paths


def _small_pools(monkeypatch, n=16):
    small = lambda n_, c, s, n_classes=10, seed=1234: synthetic_images(n, c, s, n_classes, seed)
    for module in (app64, app128, images_dir):
        monkeypatch.setattr(module, "synthetic_images", small)


@pytest.mark.parametrize("source", ["native", "dir", "dir_fallback"])
def test_app64_trains_on_the_host_paths(tmp_path, png_dir, monkeypatch, source):
    """``input native`` (the native pipeline over the pool), ``DATA_DIR``
    (the PNG directory, read at 64 px) and ``input dir`` with no
    ``DATA_DIR`` (the synthetic fallback): two iterations each, with the
    feed closed at the end."""
    _small_pools(monkeypatch)
    kw = {"native": dict(input="native"), "dir": dict(DATA_DIR=str(png_dir)),
          "dir_fallback": dict(input="dir")}[source]
    cfg = app64.Config(DIM=8, BATCH_SIZE=2, CRITIC_ITERS=2, ITERS=2, save_every=2, sample_every=2,
                       inception_every=0, out_dir=str(tmp_path / "run"), **kw)
    run = app64.setup(cfg, "cpu")
    assert (run.sampler is None) and (run.feed is not None) and ((run.pool is None) == (source != "native"))
    real = run.feed()
    assert real.shape == (2, 2, 3 * 64 * 64) and real.dtype == torch.float32
    assert -1.0 <= float(real.min()) and float(real.max()) <= 1.0
    run.feed.close()
    state, records = app64.main(cfg=cfg, device="cpu")
    assert state.step == 2 and all(math.isfinite(r["disc_cost"]) for r in records)


def test_app64_native_without_the_library_takes_the_directory_path(monkeypatch):
    """``input native`` where the library did not build reads the
    directory path (here its synthetic fallback), as the JAX app does."""
    _small_pools(monkeypatch)
    monkeypatch.setattr(app64, "native_available", lambda: False)
    monkeypatch.setattr(app64, "NativePipeline", None)
    run = app64.setup(app64.Config(DIM=8, BATCH_SIZE=2, CRITIC_ITERS=2, input="native"), "cpu")
    try:
        assert run.pool is None and run.sampler is None
        assert run.feed().shape == (2, 2, 3 * 64 * 64)
    finally:
        run.feed.close()


def test_app64_refuses_an_unknown_input():
    with pytest.raises(ValueError, match="unknown input"):
        app64.setup(app64.Config(input="tape"), "cpu")


def test_app128_trains_on_the_directory_path(tmp_path, png_dir, monkeypatch):
    """``DATA_DIR`` at 128 px (each image resized by PIL) for two
    iterations, through ``images_dir``, ``prefetch`` and
    ``stack_batches``: the same stacks as JAX's reader gives, scaled."""
    _small_pools(monkeypatch)
    monkeypatch.setattr(app128, "model_config", lambda cfg: TINY_LSUN)
    cfg = app128.Config(BATCH_SIZE=2, CRITIC_ITERS=2, ITERS=2, save_every=2, sample_every=2,
                        DATA_DIR=str(png_dir), out_dir=str(tmp_path))
    run = app128.setup(cfg, "cpu")
    want = next(jax_stack_batches(jax_images_dir.image_dir_generator(str(png_dir), 2, 128, seed=0), 2))
    got = run.feed()
    run.feed.close()
    np.testing.assert_array_equal(got.numpy(), 2.0 * (want.reshape(2, 2, -1).astype(np.float32) / 255.0 - 0.5))
    state, records = app128.main(cfg=cfg, device="cpu")
    assert state.step == 2 and all(math.isfinite(r["disc_cost"]) for r in records)
