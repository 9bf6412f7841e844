"""Diagnostics (counterpart of ``ctgan_tpu/utils/debug.py:23-55``): a
tensor's summary statistics, the non-finite tripwire, and the reference's
"[no grad!]" detector."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["assert_finite", "check_grads_exist", "print_stats", "stats"]


def stats(x: torch.Tensor) -> dict:
    """Mean, standard deviation (population), min and max of ``x`` in fp32,
    as 0-d tensors on its device (nothing waits for the device)."""
    x = x.detach().float()
    return {"mean": x.mean(), "std": x.std(unbiased=False), "min": x.min(), "max": x.max()}


def print_stats(name: str, x: torch.Tensor) -> None:
    """Print ``stats(x)`` in the JAX probe's format (waits for the
    device)."""
    s = {k: float(v) for k, v in stats(x).items()}
    print(f"{name} mean={s['mean']:.4f} std={s['std']:.4f} min={s['min']:.4f} max={s['max']:.4f}")


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


def check_grads_exist(grads: Mapping[str, torch.Tensor]) -> list[str]:
    """The names whose gradient is zero everywhere (the reference's
    "[no grad!]" warning)."""
    return [k for k, g in grads.items() if float(g.detach().abs().max()) == 0.0]
