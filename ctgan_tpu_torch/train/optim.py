"""Optimisers and gradient transforms (counterpart of
``ctgan_tpu/train/optim.py``): TF-semantics Adam and RMSProp, the
classifiers' Theano-style Adam (:class:`AdamTheano`), the LSUN fork's
Nadam and Adamax, SGD with and without momentum, moments stored in a
narrower dtype (:func:`with_state_dtype`), per-element and global-norm
gradient clipping, and the weight clip of weight-clipped WGAN.

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

Nadam (``ctgan_tpu/train/optim.py::nadam``): ``m_hat = m / (1 -
beta1^(t+1))``, ``g_hat = g / (1 - beta1^t)``, ``v_hat = v / (1 -
beta2^t)``, ``p -= lr * (beta1 * m_hat + (1 - beta1) * g_hat) / (sqrt(v_hat)
+ eps)``.  Adamax: ``u = max(beta2 * u, |g|)``, ``p -= lr / (1 - beta1^t) *
m / (u + eps)``.  Momentum: ``mom = mu * mom + g``, ``p -= lr * mom`` (or,
Nesterov, ``lr * (g + mu * mom)``).  The state names are the JAX package's:
nadam ``m``/``v``/``t``, adamax ``m``/``u``/``t``, momentum ``mom``, SGD
none.

Parameters and optimiser state are updated in place (the JAX update returns
new arrays); each update is one multi-tensor pass per term.  Every rule
computes in fp32 whatever dtype its moments are stored in: a narrower
moment (:func:`with_state_dtype`) is read into an fp32 copy, the update and
the parameters are computed from the unrounded new moments, and the new
moments are written back with one round-to-nearest-even cast; the
parameters go through in groups of at most ``GROUP_ELEMENTS`` elements, so
that the fp32 copies do not take back the memory the narrower storage saves
(``ctgan_tpu/train/optim.py:212-245`` upcasts, runs the rule and downcasts
the same way); scalars such as ``t`` keep their type.
:func:`clip_params_by_value` clips in place too; the gradient transforms
return new tensors.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.rng import Randomness, host_to_device

__all__ = [
    "Adam", "AdamTheano", "Adamax", "Momentum", "Nadam", "RMSProp", "Sgd", "adam_mismatches",
    "clip_grads_by_global_norm", "clip_grads_by_value", "clip_params_by_value", "device_scalars", "global_norm",
    "with_state_dtype",
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


def _zeros(params: dict) -> dict:
    return {k: torch.zeros_like(v) for k, v in params.items()}


# elements whose narrower moments are upcast at a time: bounds the fp32 working copies (4 MiB for
# each of a group's working tensors: the moments and the update's temporaries)
GROUP_ELEMENTS = 1 << 20


def _groups(params: dict, state: dict) -> list[list[str]]:
    """The parameter names in update order, in groups updated one after the
    other: one group where every moment is fp32 (updated in place); else
    groups of at most ``GROUP_ELEMENTS`` elements (a larger tensor alone),
    so that the fp32 working copies of narrower moments never take more
    memory than one group's."""
    names = list(params)
    moments = [v for v in state.values() if isinstance(v, dict)]
    if all(m[k].dtype == torch.float32 for m in moments for k in names):
        return [names]
    groups, size = [[]], 0
    for k in names:
        if groups[-1] and size + params[k].numel() > GROUP_ELEMENTS:
            groups.append([])
            size = 0
        groups[-1].append(k)
        size += params[k].numel()
    return groups


def _working(stored: list) -> list:
    """fp32 working tensors of stored moments: the moments themselves where
    they are fp32 (updated in place), else fp32 copies made in one
    multi-tensor pass."""
    work = [s if s.dtype == torch.float32 else torch.empty_like(s, dtype=torch.float32) for s in stored]
    narrow = [(w, s) for w, s in zip(work, stored) if w is not s]
    if narrow:
        torch._foreach_copy_([w for w, _ in narrow], [s for _, s in narrow])
    return work


def _store(stored: list, work: list) -> None:
    """Write the new moments back into narrower storage, one
    round-to-nearest-even cast each (nothing to do where ``work`` is the
    storage)."""
    pairs = [(s, w) for s, w in zip(stored, work) if s is not w]
    if pairs:
        torch._foreach_copy_([s for s, _ in pairs], [w for _, w in pairs])


def _moments(state: dict, key: str, names: list) -> tuple[list, list]:
    """(stored, fp32 working) tensors of ``state[key]`` in ``names``' order."""
    stored = [state[key][k] for k in names]
    return stored, _working(stored)


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
        for names in _groups(params, state):
            ps = [params[k] for k in names]
            gs = [grads[k] for k in names]
            m_stored, ms = _moments(state, "m", names)
            v_stored, vs = _moments(state, "v", names)
            torch._foreach_mul_(ms, self.beta1)
            torch._foreach_add_(ms, gs, alpha=1.0 - self.beta1)
            torch._foreach_mul_(vs, self.beta2)
            torch._foreach_addcmul_(vs, gs, gs, value=1.0 - self.beta2)
            denom = torch._foreach_sqrt(vs)
            torch._foreach_add_(denom, self.eps)
            delta = torch._foreach_mul(ms, lr_t)
            torch._foreach_div_(delta, denom)
            torch._foreach_sub_(ps, delta)
            _store(m_stored, ms)
            _store(v_stored, vs)


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
        for names in _groups(params, state):
            ps = [params[k] for k in names]
            gs = [grads[k] for k in names]
            m_stored, ms = _moments(state, "m", names)
            v_stored, vs = _moments(state, "v", names)
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
            _store(m_stored, ms)
            _store(v_stored, vs)


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
        for names in _groups(params, state):
            ps = [params[k] for k in names]
            gs = [grads[k] for k in names]
            ms_stored, mss = _moments(state, "ms", names)
            mom_stored, moms = _moments(state, "mom", names)
            torch._foreach_mul_(mss, self.rho)
            torch._foreach_addcmul_(mss, gs, gs, value=1.0 - self.rho)
            denom = torch._foreach_add(mss, self.eps)
            torch._foreach_sqrt_(denom)
            delta = torch._foreach_mul(gs, lr)
            torch._foreach_div_(delta, denom)
            torch._foreach_mul_(moms, self.momentum)
            torch._foreach_add_(moms, delta)
            torch._foreach_sub_(ps, moms)
            _store(ms_stored, mss)
            _store(mom_stored, moms)


class Nadam:
    """Nesterov Adam of the LSUN fork (``ctgan_tpu/train/optim.py:135-160``)."""

    def __init__(self, lr: float | Callable[[int], float] = 1e-3, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.beta1, self.beta2, self.eps = lr, beta1, beta2, eps

    def init(self, params: dict) -> dict:
        return {"m": _zeros(params), "v": _zeros(params), "t": 0.0}

    def scalars(self, t: float, step: int) -> np.ndarray:
        """``[1 - beta1^(t+1), 1 - beta1^t, 1 - beta2^t, lr]`` in fp32 for
        the ``t``-th update at ``step``."""
        t32, one = np.float32(t), np.float32(1.0)
        b1, b2 = np.float32(self.beta1), np.float32(self.beta2)
        return np.array([one - b1 ** (t32 + one), one - b1 ** t32, one - b2 ** t32,
                         np.float32(_lr_at(self.lr, step))], np.float32)

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict, step: int, rand=None) -> None:
        def host(step: int) -> np.ndarray:
            state["t"] += 1.0
            return self.scalars(state["t"], step)

        c_m, c_g, c_v, lr = device_scalars(rand, host, step, params)
        for names in _groups(params, state):
            ps = [params[k] for k in names]
            gs = [grads[k] for k in names]
            m_stored, ms = _moments(state, "m", names)
            v_stored, vs = _moments(state, "v", names)
            torch._foreach_mul_(ms, self.beta1)
            torch._foreach_add_(ms, gs, alpha=1.0 - self.beta1)
            torch._foreach_mul_(vs, self.beta2)
            torch._foreach_addcmul_(vs, gs, gs, value=1.0 - self.beta2)
            num = torch._foreach_div(ms, c_m)
            torch._foreach_mul_(num, self.beta1)
            torch._foreach_add_(num, torch._foreach_div(gs, c_g), alpha=1.0 - self.beta1)
            torch._foreach_mul_(num, lr)
            denom = torch._foreach_div(vs, c_v)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            torch._foreach_div_(num, denom)
            torch._foreach_sub_(ps, num)
            _store(m_stored, ms)
            _store(v_stored, vs)


class Adamax:
    """Adamax of the LSUN fork (``ctgan_tpu/train/optim.py:163-184``)."""

    def __init__(self, lr: float | Callable[[int], float] = 2e-3, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.beta1, self.beta2, self.eps = lr, beta1, beta2, eps

    def init(self, params: dict) -> dict:
        return {"m": _zeros(params), "u": _zeros(params), "t": 0.0}

    def scalars(self, t: float, step: int) -> np.ndarray:
        """``[lr / (1 - beta1^t)]`` in fp32 for the ``t``-th update at
        ``step``."""
        t32, one = np.float32(t), np.float32(1.0)
        return np.array([np.float32(_lr_at(self.lr, step)) / (one - np.float32(self.beta1) ** t32)], np.float32)

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict, step: int, rand=None) -> None:
        def host(step: int) -> np.ndarray:
            state["t"] += 1.0
            return self.scalars(state["t"], step)

        lr = device_scalars(rand, host, step, params)[0]
        for names in _groups(params, state):
            ps = [params[k] for k in names]
            gs = [grads[k] for k in names]
            m_stored, ms = _moments(state, "m", names)
            u_stored, us = _moments(state, "u", names)
            torch._foreach_mul_(ms, self.beta1)
            torch._foreach_add_(ms, gs, alpha=1.0 - self.beta1)
            torch._foreach_mul_(us, self.beta2)
            torch._foreach_maximum_(us, torch._foreach_abs(gs))
            delta = torch._foreach_mul(ms, lr)
            torch._foreach_div_(delta, torch._foreach_add(us, self.eps))
            torch._foreach_sub_(ps, delta)
            _store(m_stored, ms)
            _store(u_stored, us)


class Sgd:
    """``p -= lr * g`` (``ctgan_tpu/train/optim.py:187-195``); no state."""

    def __init__(self, lr: float | Callable[[int], float] = 1e-2):
        self.lr = lr

    def init(self, params: dict) -> dict:
        return {}

    def scalars(self, step: int) -> np.ndarray:
        return np.array([_lr_at(self.lr, step)], np.float32)

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict, step: int, rand=None) -> None:
        lr = device_scalars(rand, self.scalars, step, params)[0]
        names = list(params)
        torch._foreach_sub_([params[k] for k in names], torch._foreach_mul([grads[k] for k in names], lr))


class Momentum:
    """SGD with (Nesterov) momentum (``ctgan_tpu/train/optim.py:198-209``)."""

    def __init__(self, lr: float | Callable[[int], float] = 1e-2, mu: float = 0.9, nesterov: bool = False):
        self.lr, self.mu, self.nesterov = lr, mu, nesterov

    def init(self, params: dict) -> dict:
        return {"mom": _zeros(params)}

    def scalars(self, step: int) -> np.ndarray:
        return np.array([_lr_at(self.lr, step)], np.float32)

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict, step: int, rand=None) -> None:
        lr = device_scalars(rand, self.scalars, step, params)[0]
        for names in _groups(params, state):
            ps = [params[k] for k in names]
            gs = [grads[k] for k in names]
            mom_stored, moms = _moments(state, "mom", names)
            torch._foreach_mul_(moms, self.mu)
            torch._foreach_add_(moms, gs)
            direction = torch._foreach_add(gs, moms, alpha=self.mu) if self.nesterov else moms
            torch._foreach_sub_(ps, torch._foreach_mul(direction, lr))
            _store(mom_stored, moms)


class StateIn:
    """``opt`` with its per-parameter state stored in ``dtype``: the same
    rule and scalars (every rule here computes in fp32 from narrower
    moments, see the module's docstring); only ``init`` differs."""

    def __init__(self, opt, dtype: torch.dtype):
        self.opt, self.dtype = opt, dtype

    def init(self, params: dict) -> dict:
        return {k: {n: t.to(self.dtype) for n, t in v.items()} if isinstance(v, dict) else v
                for k, v in self.opt.init(params).items()}

    def update(self, grads: dict, state: dict, params: dict, step: int, rand=None) -> None:
        self.opt.update(grads, state, params, step, rand)

    def __getattr__(self, name: str):
        if name == "opt":  # not set yet (a copy in the making)
            raise AttributeError(name)
        return getattr(self.opt, name)


def with_state_dtype(opt, dtype):
    """``opt`` storing its moment dicts in ``dtype`` (a torch floating dtype
    or its name, e.g. ``"bfloat16"``); fp32 gives ``opt`` itself
    (``ctgan_tpu/train/optim.py:212-245``)."""
    dtype = getattr(torch, dtype, None) if isinstance(dtype, str) else dtype
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"optimiser state dtype must be a floating dtype, not {dtype!r}")
    return opt if dtype == torch.float32 else StateIn(opt, dtype)


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
