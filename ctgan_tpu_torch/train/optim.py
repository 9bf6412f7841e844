"""Optimisers and gradient transforms (counterpart of
``ctgan_tpu/train/optim.py``): TF-semantics Adam and RMSProp, the
classifiers' Theano-style Adam (:class:`AdamTheano`), per-element
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

Per-step scalars (Adam's ``lr_t``, the Theano Adam's corrections and
learning rate, RMSProp's learning rate) are computed on the host in fp32
(:meth:`scalars`; ``t`` advances there) and reach the update as a 1-D fp32
tensor on the parameters' device (:func:`device_scalars`): from the step's
provider (``Randomness.from_host``), so that a CUDA graph that captured the
update reads each step's values from its input buffer instead of replaying
the first step's.  The update multiplies by that tensor:
``p -= (lr_t * m) / (sqrt(v) + eps)``, the JAX expression's order
(``ctgan_tpu/train/optim.py:84``), where ``addcdiv`` with a float value
would take ``lr_t * (m / d)`` on the card; it costs two multi-tensor passes
more than one ``addcdiv`` and one temporary per parameter.

Parameters and optimiser state are updated in place (the JAX update returns
new arrays); each update is one multi-tensor pass per term.
:func:`clip_params_by_value` clips in place too; the gradient transforms
return new tensors.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.rng import Randomness, host_to_device

__all__ = [
    "Adam", "AdamTheano", "RMSProp", "adam_mismatches", "clip_grads_by_global_norm", "clip_grads_by_value",
    "clip_params_by_value", "device_scalars", "global_norm",
]


def _lr_at(lr, step: int) -> float:
    return lr(step) if callable(lr) else lr


def device_scalars(rand, host: Callable[[int], np.ndarray], step: int, params: dict) -> torch.Tensor:
    """``host(step)``, an update's fp32 scalars, as a 1-D tensor on the
    parameters' device.  A provider (``core.rng.Randomness`` or a static
    one) hands it out, so a captured step reads each step's values; without
    one (``rand`` None or a test's injected draws) ``host`` runs now and its
    values are copied over."""
    if isinstance(rand, Randomness):
        return rand.from_host(host, step)
    return host_to_device(torch.from_numpy(host(step)), next(iter(params.values())).device)


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

    def scalars(self, t: float, step: int) -> np.ndarray:
        """``[lr_t]`` in fp32 for the ``t``-th update at ``step``."""
        return np.array([self.lr_t(t, step)], np.float32)

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict, step: int, rand=None) -> None:
        """One step on ``params`` and ``state`` in place; ``t`` advances on
        the host where the scalars are computed."""

        def host(step: int) -> np.ndarray:
            state["t"] += 1.0
            return self.scalars(state["t"], step)

        lr_t = device_scalars(rand, host, step, params)[0]
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
        delta = torch._foreach_mul(ms, lr_t)
        torch._foreach_div_(delta, denom)
        torch._foreach_sub_(ps, delta)


class AdamTheano:
    """The classifiers' hand-written Adam (``ctgan_tpu/train/optim.py:90-112``,
    ``nn.py:30-47`` of the reference): ``t`` starts at 1;
    ``m_hat = m / (1 - mom1^t)``, ``v_hat = v / (1 - mom2^t)`` and ``p -= lr *
    m_hat / sqrt(v_hat + eps)``, eps inside the square root.  The
    corrections are computed on the host in fp32, as the JAX update computes
    them; ``lr`` may be a schedule of the step."""

    def __init__(self, lr: float | Callable[[int], float] = 3e-4, mom1: float = 0.9,
                 mom2: float = 0.999, eps: float = 1e-8):
        self.lr, self.mom1, self.mom2, self.eps = lr, mom1, mom2, eps

    def init(self, params: dict) -> dict:
        return {
            "m": {k: torch.zeros_like(v) for k, v in params.items()},
            "v": {k: torch.zeros_like(v) for k, v in params.items()},
            "t": 1.0,
        }

    def scalars(self, t: float, step: int) -> np.ndarray:
        """``[1 - mom1^t, 1 - mom2^t, lr]`` in fp32 for the update with
        count ``t`` at ``step``."""
        t32, one = np.float32(t), np.float32(1.0)
        return np.array([one - np.float32(self.mom1) ** t32, one - np.float32(self.mom2) ** t32,
                         np.float32(_lr_at(self.lr, step))], np.float32)

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict, step: int, rand=None) -> None:
        """One step on ``params`` and ``state`` in place; ``t`` advances on
        the host where the scalars are computed."""

        def host(step: int) -> np.ndarray:
            out = self.scalars(state["t"], step)
            state["t"] += 1.0
            return out

        c1, c2, lr = device_scalars(rand, host, step, params)
        names = list(params)
        ps = [params[k] for k in names]
        gs = [grads[k] for k in names]
        ms = [state["m"][k] for k in names]
        vs = [state["v"][k] for k in names]
        torch._foreach_mul_(ms, self.mom1)
        torch._foreach_add_(ms, gs, alpha=1.0 - self.mom1)
        torch._foreach_mul_(vs, self.mom2)
        torch._foreach_addcmul_(vs, gs, gs, value=1.0 - self.mom2)
        delta = torch._foreach_div(ms, c1)
        denom = torch._foreach_div(vs, c2)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_sqrt_(denom)
        torch._foreach_mul_(delta, lr)
        torch._foreach_div_(delta, denom)
        torch._foreach_sub_(ps, delta)


class RMSProp:
    def __init__(self, lr: float | Callable[[int], float] = 5e-5, rho: float = 0.9,
                 momentum: float = 0.0, eps: float = 1e-10):
        self.lr, self.rho, self.momentum, self.eps = lr, rho, momentum, eps

    def init(self, params: dict) -> dict:
        return {
            "ms": {k: torch.zeros_like(v) for k, v in params.items()},
            "mom": {k: torch.zeros_like(v) for k, v in params.items()},
        }

    def scalars(self, step: int) -> np.ndarray:
        """``[lr]`` in fp32 at ``step``."""
        return np.array([_lr_at(self.lr, step)], np.float32)

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict, step: int, rand=None) -> None:
        """One step on ``params`` and ``state`` in place."""
        lr = device_scalars(rand, self.scalars, step, params)[0]
        names = list(params)
        ps = [params[k] for k in names]
        gs = [grads[k] for k in names]
        mss = [state["ms"][k] for k in names]
        moms = [state["mom"][k] for k in names]
        torch._foreach_mul_(mss, self.rho)
        torch._foreach_addcmul_(mss, gs, gs, value=1.0 - self.rho)
        denom = torch._foreach_add(mss, self.eps)
        torch._foreach_sqrt_(denom)
        delta = torch._foreach_mul(gs, lr)
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
