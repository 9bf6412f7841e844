"""Non-finite tripwire (counterpart of ``assert_finite`` in
``ctgan_tpu/utils/debug.py``)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["assert_finite"]


def _leaves(tree, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_finite(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming every leaf (tensor, array or
    number) of ``tree`` that holds a NaN or an infinity.  Reading a device
    tensor waits for it."""
    bad = []
    for path, leaf in _leaves(tree):
        ok = bool(torch.isfinite(leaf).all()) if isinstance(leaf, torch.Tensor) else bool(
            np.isfinite(np.asarray(leaf)).all())
        if not ok:
            bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
