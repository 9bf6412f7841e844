"""TF-semantics Adam (counterpart of ``ctgan_tpu/train/optim.py::adam``).

``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` and
``p -= lr_t * m / (sqrt(v) + eps)``: eps is added to the uncorrected
``sqrt(v)``.  ``torch.optim.Adam`` adds it after bias-correcting, so its
numbers differ.  ``t`` is a float in the state and ``lr_t`` is computed on
the host in fp32, as the JAX update computes it.

Parameters and moments are updated in place (the JAX update returns new
arrays); each update is one multi-tensor pass per term.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["Adam", "adam_mismatches"]


class Adam:
    def __init__(self, lr: float | Callable[[int], float], beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8):
        self.lr, self.beta1, self.beta2, self.eps = lr, beta1, beta2, eps

    def init(self, params: dict) -> dict:
        return {
            "m": {k: torch.zeros_like(v) for k, v in params.items()},
            "v": {k: torch.zeros_like(v) for k, v in params.items()},
            "t": 0.0,
        }

    def lr_t(self, t: float, step: int) -> float:
        lr = self.lr(step) if callable(self.lr) else self.lr
        t32, one = np.float32(t), np.float32(1.0)
        lr_t = np.float32(lr) * np.sqrt(one - np.float32(self.beta2) ** t32)
        return float(lr_t / (one - np.float32(self.beta1) ** t32))

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict, step: int) -> None:
        """One step on ``params`` and ``state`` in place."""
        state["t"] += 1.0
        lr_t = self.lr_t(state["t"], step)
        names = list(params)
        ps = [params[k] for k in names]
        gs = [grads[k] for k in names]
        ms = [state["m"][k] for k in names]
        vs = [state["v"][k] for k in names]
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, gs, alpha=1.0 - self.beta1)
        torch._foreach_mul_(vs, self.beta2)
        torch._foreach_addcmul_(vs, gs, gs, value=1.0 - self.beta2)
        denom = torch._foreach_sqrt(vs)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(ps, ms, denom, value=-lr_t)


def adam_mismatches(got: dict, want: dict, *, lr: float, n_updates: int, zero_grad=(),
                    atol: float = 1e-6) -> list[str]:
    """Where two runs' parameters (same names, any layout both share)
    disagree by more than Adam's rounding allows; empty if they agree.

    A TF-Adam step moves an element by about lr * g / (|g| + 3e-8), which
    is lr * sign(g) unless |g| is tiny.  So an element whose gradient is
    near zero, where the two runs' rounding decides its sign, can step the
    other way: a difference of up to 2 * lr.  Every element must lie within
    ``2 * lr * n_updates + atol``, and within ``atol`` except for the
    parameters in ``zero_grad`` (zero gradient in exact arithmetic, so any
    element may flip) and, elsewhere, at most one element or 0.1% of a
    tensor, whichever is more.
    """
    bad = []
    if set(got) != set(want):
        return [f"names differ: {sorted(set(got) ^ set(want))}"]
    bound = 2 * lr * n_updates + atol
    for name in want:
        diff = np.abs(np.asarray(got[name], np.float64) - np.asarray(want[name], np.float64))
        if diff.max() > bound:
            bad.append(f"{name}: max diff {diff.max():.3g} > {bound:.3g}")
        elif name not in zero_grad and np.sum(diff > atol) > max(1, diff.size // 1000):
            bad.append(f"{name}: {int(np.sum(diff > atol))} of {diff.size} elements beyond {atol}")
    return bad
