"""Learning-rate schedules (counterpart of ``ctgan_tpu/train/schedules.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["linear_decay"]


def linear_decay(lr: float, total_iters: int):
    """step -> lr * max(0, 1 - step/total), in fp32 as the JAX schedule."""

    def schedule(step: int) -> np.float32:
        frac = np.maximum(np.float32(0.0), np.float32(1.0) - np.float32(step) / np.float32(total_iters))
        return np.float32(lr) * frac

    return schedule
