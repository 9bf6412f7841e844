"""Sample grids (counterpart of ``ctgan_tpu/utils/images.py``).

:func:`make_grid`, :func:`img_tile` and :func:`img_stretch` are the JAX
package's.  :func:`save_images` writes the grid as a PNG itself (8-bit
grayscale or RGB, one zlib stream in one ``IDAT`` chunk, no row filter)
with ``zlib`` and ``struct``, so the port needs no imaging library; any PNG
reader decodes it to :func:`make_grid`'s array.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["make_grid", "save_images", "img_tile", "img_stretch", "png_bytes"]


def img_stretch(img: np.ndarray) -> np.ndarray:
    """Stretch values to [0, 1]."""
    img = np.asarray(img, dtype="float64")
    lo, hi = img.min(), img.max()
    if hi > lo:
        img = (img - lo) / (hi - lo)
    return img


def img_tile(
    imgs: np.ndarray,
    *,
    aspect_ratio: float = 1.0,
    border: int = 1,
    border_color: float = 0.0,
    stretch: bool = False,
) -> np.ndarray:
    """Tile [N, H, W(, C)] images with borders."""
    imgs = np.asarray(imgs, dtype="float64")
    if stretch:
        imgs = img_stretch(imgs)
    n = len(imgs)
    tile_h = int(np.ceil(np.sqrt(n * aspect_ratio)))
    tile_w = int(np.ceil(n / tile_h))
    h, w = imgs.shape[1:3]
    extra = imgs.shape[3:]
    out = np.full(
        (tile_h * h + (tile_h - 1) * border, tile_w * w + (tile_w - 1) * border) + extra,
        border_color,
    )
    for i, im in enumerate(imgs):
        r, c = divmod(i, tile_w)
        y, x = r * (h + border), c * (w + border)
        out[y : y + h, x : x + w] = im
    return out


def make_grid(x: np.ndarray) -> np.ndarray:
    """[N,H,W] or [N,C,H,W] -> one HW(C) uint8 grid image."""
    x = np.asarray(x)
    if x.dtype.kind == "f":
        x = (255.99 * np.clip(x, 0.0, 1.0)).astype("uint8")
    n_samples = x.shape[0]
    rows = int(np.sqrt(n_samples))
    while n_samples % rows != 0:
        rows -= 1
    cols = n_samples // rows

    if x.ndim == 4:  # BCHW -> BHWC
        x = x.transpose(0, 2, 3, 1)
        h, w, c = x.shape[1:]
        img = np.zeros((h * rows, w * cols, c), dtype="uint8")
    else:
        h, w = x.shape[1:]
        img = np.zeros((h * rows, w * cols), dtype="uint8")

    for n, sample in enumerate(x):
        i, j = n % cols, n // cols
        img[j * h : j * h + h, i * w : i * w + w] = sample
    return img


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def png_bytes(img: np.ndarray) -> bytes:
    """A PNG of a uint8 ``[H, W]`` (grayscale) or ``[H, W, 3]`` (RGB) image."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        color_type = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
    else:
        raise ValueError(f"PNG needs [H, W] or [H, W, 3] pixels, got {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter type 0 per row
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_images(x: np.ndarray, save_path: str) -> None:
    """Write :func:`make_grid` of ``x`` to ``save_path`` as a PNG."""
    with open(save_path, "wb") as f:
        f.write(png_bytes(make_grid(x)))
