"""Handwriting stroke utilities (own copy of
``ctgan_tpu/utils/handwriting.py``, the reference's
``LSUN_bedrooms/handwriting_utils.py`` for IAM-style online handwriting).

Strokes are ``[T, 3]`` arrays of (dx, dy, pen_up).  They are drawn into a
raster with NumPy line drawing (the reference rendered SVG with an external
tool).
"""

from __future__ import annotations

import numpy as np

__all__ = ["strokes_to_points", "render_strokes", "normalize_strokes"]


def strokes_to_points(strokes: np.ndarray) -> list[np.ndarray]:
    """Offsets to absolute-coordinate polylines, split after each pen-up;
    a polyline of one point is dropped."""
    pts = np.cumsum(strokes[:, :2], axis=0)
    lines, start = [], 0
    for i in range(len(strokes)):
        if strokes[i, 2] > 0.5:
            seg = pts[start:i + 1]
            if len(seg) > 1:
                lines.append(seg)
            start = i + 1
    if start < len(pts) - 1:
        lines.append(pts[start:])
    return lines


def normalize_strokes(strokes: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """The offsets divided by their standard deviation (1 where it is 0),
    times ``scale``; float32."""
    out = np.asarray(strokes, "float32").copy()
    std = out[:, :2].std() or 1.0
    out[:, :2] = out[:, :2] / std * scale
    return out


def _draw_line(img: np.ndarray, x0, y0, x1, y1) -> None:
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    xs = np.linspace(x0, x1, n).round().astype(int)
    ys = np.linspace(y0, y1, n).round().astype(int)
    h, w = img.shape
    valid = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[valid], xs[valid]] = 255


def render_strokes(strokes: np.ndarray, size: int = 128, margin: int = 8) -> np.ndarray:
    """One stroke sequence as a uint8 ``[size, size]`` image, scaled to fit
    inside ``margin``, y up."""
    lines = strokes_to_points(np.asarray(strokes, "float32"))
    img = np.zeros((size, size), np.uint8)
    if not lines:
        return img
    allpts = np.concatenate(lines)
    lo = allpts.min(axis=0)
    span = np.maximum(allpts.max(axis=0) - lo, 1e-6)
    s = (size - 2 * margin) / span.max()
    for seg in lines:
        p = (seg - lo) * s + margin
        for i in range(len(p) - 1):
            _draw_line(img, p[i, 0], p[i, 1], p[i + 1, 0], p[i + 1, 1])
    return img[::-1]
