"""Optimisers and gradient transforms (counterpart of
``ctgan_tpu/train/optim.py``): TF-semantics Adam and RMSProp, per-element
and global-norm gradient clipping, and the weight clip of weight-clipped
WGAN.

Adam (``ctgan_tpu/train/optim.py::adam``):
``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` and
``p -= lr_t * m / (sqrt(v) + eps)``: eps is added to the uncorrected
``sqrt(v)``.  ``torch.optim.Adam`` adds it after bias-correcting, so its
numbers differ.  ``t`` is a float in the state and ``lr_t`` is computed on
the host in fp32, as the JAX update computes it.

RMSProp (``ctgan_tpu/train/optim.py::rmsprop``, TF semantics):
``ms = rho * ms + (1 - rho) * g^2``, ``mom = momentum * mom + lr * g /
sqrt(ms + eps)``, ``p -= mom``; eps inside the square root.

Parameters and optimiser state are updated in place (the JAX update returns
new arrays); each update is one multi-tensor pass per term.
:func:`clip_params_by_value` clips in place too; the gradient transforms
return new tensors.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = [
    "Adam", "RMSProp", "adam_mismatches", "clip_grads_by_global_norm", "clip_grads_by_value",
    "clip_params_by_value", "global_norm",
]


def _lr_at(lr, step: int) -> float:
    return lr(step) if callable(lr) else lr


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
        lr = _lr_at(self.lr, step)
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


class RMSProp:
    def __init__(self, lr: float | Callable[[int], float] = 5e-5, rho: float = 0.9,
                 momentum: float = 0.0, eps: float = 1e-10):
        self.lr, self.rho, self.momentum, self.eps = lr, rho, momentum, eps

    def init(self, params: dict) -> dict:
        return {
            "ms": {k: torch.zeros_like(v) for k, v in params.items()},
            "mom": {k: torch.zeros_like(v) for k, v in params.items()},
        }

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict, step: int) -> None:
        """One step on ``params`` and ``state`` in place."""
        names = list(params)
        ps = [params[k] for k in names]
        gs = [grads[k] for k in names]
        mss = [state["ms"][k] for k in names]
        moms = [state["mom"][k] for k in names]
        torch._foreach_mul_(mss, self.rho)
        torch._foreach_addcmul_(mss, gs, gs, value=1.0 - self.rho)
        denom = torch._foreach_add(mss, self.eps)
        torch._foreach_sqrt_(denom)
        delta = torch._foreach_mul(gs, _lr_at(self.lr, step))
        torch._foreach_div_(delta, denom)
        torch._foreach_mul_(moms, self.momentum)
        torch._foreach_add_(moms, delta)
        torch._foreach_sub_(ps, moms)


def clip_grads_by_value(grads: dict, limit: float = 1.0) -> dict:
    """Each element clipped into ``[-limit, limit]``."""
    return {k: g.clamp(-limit, limit) for k, g in grads.items()}


def global_norm(grads: dict) -> torch.Tensor:
    """The L2 norm of all gradients together."""
    return torch.sqrt(sum(g.square().sum() for g in grads.values()))


def clip_grads_by_global_norm(grads: dict, max_norm: float = 5.0) -> tuple[dict, torch.Tensor]:
    """The gradients scaled so that their global norm is at most
    ``max_norm``, and the norm before clipping (the ``gradnorm`` metric)."""
    norm = global_norm(grads)
    factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * factor for k, g in grads.items()}, norm


@torch.no_grad()
def clip_params_by_value(params: dict, limit: float = 0.01) -> None:
    """Weight-clipped WGAN: every parameter clipped into ``[-limit, limit]``,
    in place, after each critic update."""
    for p in params.values():
        p.clamp_(-limit, limit)


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
