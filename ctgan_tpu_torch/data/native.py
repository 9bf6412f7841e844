"""``ctypes`` binding to the native host-IO library ``native/ctgan_io.cpp``
(own copy of ``ctgan_tpu/data/native.py``; the C++ source is shared and
stays as it is).

The library is compiled with ``g++`` on first use into
``build/ctgan_tpu_torch/native/<hash>/libctgan_io.so`` under the repository
root, ``<hash>`` covering the source and the flags; never into ``native/``.
Where it cannot be built or loaded, :func:`load_library` returns None (the
reason is kept in :func:`build_error`) and every entry point below raises
``RuntimeError``: callers that have another path (the 64 px app's ``input
native``) ask :func:`native_available` first.

* :func:`decode_idx`, :func:`decode_cifar_bin`: the MNIST IDX and CIFAR-10
  binary decoders.
* :class:`NativePipeline`: shuffled ``[K, B, D]`` float32 batches made by
  worker threads, with per-image flips and ``x * scale + shift``; its
  ``(seed, cursor)`` state resumes it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["NativePipeline", "build_error", "decode_cifar_bin", "decode_idx", "library_path", "load_library",
           "native_available"]

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "ctgan_io.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
BUILD_TIMEOUT_S = 300

_lib: ctypes.CDLL | None = None
_error: str | None = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return _ROOT / "build" / "ctgan_tpu_torch" / "native" / digest.hexdigest()[:16] / "libctgan_io.so"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"],
                       check=True, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)


def _declare(lib: ctypes.CDLL) -> None:
    lib.ctgan_decode_idx.restype = ctypes.c_int
    lib.ctgan_decode_idx.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                                     ctypes.c_void_p]
    lib.ctgan_decode_cifar_bin.restype = ctypes.c_int
    lib.ctgan_decode_cifar_bin.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.ctgan_pipeline_create.restype = ctypes.c_void_p
    lib.ctgan_pipeline_create.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.ctgan_pipeline_next.restype = ctypes.c_int
    lib.ctgan_pipeline_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.ctgan_pipeline_cursor.restype = ctypes.c_int64
    lib.ctgan_pipeline_cursor.argtypes = [ctypes.c_void_p]
    lib.ctgan_pipeline_seek.restype = None
    lib.ctgan_pipeline_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.ctgan_pipeline_destroy.restype = None
    lib.ctgan_pipeline_destroy.argtypes = [ctypes.c_void_p]


def load_library() -> ctypes.CDLL | None:
    """The library, built first if needed; None if it cannot be built or
    loaded (tried once per process)."""
    global _lib, _error, _tried
    if _tried:
        return _lib
    _tried = True
    so = library_path()
    try:
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", None) or ""
        _error = f"{type(e).__name__}: {e} {detail}".strip()
        return None
    _declare(lib)
    _lib = lib
    return _lib


def native_available() -> bool:
    return load_library() is not None


def build_error() -> str | None:
    """Why :func:`load_library` returned None, if it did."""
    load_library()
    return _error


def _require() -> ctypes.CDLL:
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"the native ctgan_io library is unavailable: {_error}")
    return lib


def decode_idx(raw: bytes) -> np.ndarray:
    """An MNIST IDX blob as a uint8 array of its dims."""
    lib = _require()
    ndim = raw[3]
    dims = (ctypes.c_int64 * 3)()
    rc = lib.ctgan_decode_idx(raw, len(raw), dims, None)
    if rc != 0:
        raise ValueError(f"bad IDX data (rc={rc})")
    shape = list(dims)[:ndim]
    out = np.empty(int(np.prod(shape)), np.uint8)
    lib.ctgan_decode_idx(raw, len(raw), dims, out.ctypes.data_as(ctypes.c_void_p))
    return out.reshape(shape)


def decode_cifar_bin(raw: bytes) -> tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 binary records -> (uint8 images ``[N, 3072]``, int64 labels)."""
    lib = _require()
    n = len(raw) // 3073
    images = np.empty((n, 3072), np.uint8)
    labels = np.empty(n, np.int64)
    n_out = ctypes.c_int64()
    rc = lib.ctgan_decode_cifar_bin(raw, len(raw), images.ctypes.data_as(ctypes.c_void_p),
                                    labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), ctypes.byref(n_out))
    if rc != 0:
        raise ValueError("bad CIFAR binary data")
    return images, labels


class NativePipeline:
    """Shuffled epochs of ``[K, B, D]`` float32 stacks (and ``[K, B]``
    labels), ``x * scale + shift``, each image flipped left to right at
    random when ``flip`` and ``chw`` are given.  The batches are a function
    of ``(seed, cursor)``: :meth:`state`/:meth:`set_state` resume them.
    :meth:`close` stops the worker threads."""

    _handle = None

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray | None,
        batch_size: int,
        critic_iters: int = 1,
        *,
        chw: tuple | None = None,
        flip: bool = False,
        scale: float = 2.0 / 255.0,
        shift: float = -1.0,
        seed: int = 0,
        n_threads: int = 2,
        depth: int = 4,
    ):
        self.images = np.ascontiguousarray(images, np.uint8)
        self.labels = np.ascontiguousarray(labels, np.int64) if labels is not None else None
        self.batch, self.k, self.item = batch_size, critic_iters, self.images.shape[1]
        self.seed = seed
        self._lib = _require()
        c, h, w = chw if chw else (1, 0, 0)
        self._handle = self._lib.ctgan_pipeline_create(
            self.images.ctypes.data_as(ctypes.c_void_p),
            self.labels.ctypes.data_as(ctypes.c_void_p) if self.labels is not None else None,
            self.images.shape[0], self.item, batch_size, critic_iters,
            c, h, w, int(flip), scale, shift, seed, n_threads, depth,
        )

    def next(self) -> tuple[np.ndarray, np.ndarray | None]:
        per = self.k * self.batch
        images = np.empty((per, self.item), np.float32)
        labels = np.empty(per, np.int64) if self.labels is not None else None
        rc = self._lib.ctgan_pipeline_next(
            self._handle, images.ctypes.data_as(ctypes.c_void_p),
            labels.ctypes.data_as(ctypes.c_void_p) if labels is not None else None)
        if rc != 0:
            raise RuntimeError("pipeline stopped")
        out_l = labels.reshape(self.k, self.batch) if labels is not None else None
        return images.reshape(self.k, self.batch, self.item), out_l

    def state(self) -> dict:
        return {"seed": self.seed, "cursor": int(self._lib.ctgan_pipeline_cursor(self._handle))}

    def set_state(self, state: dict) -> None:
        self._lib.ctgan_pipeline_seek(self._handle, int(state["cursor"]))

    def close(self) -> None:
        if self._handle is not None:
            self._lib.ctgan_pipeline_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
