"""The one place where parameters change layout between the two packages.

The JAX package stores conv filters as HWIO and linear weights as
``[in, out]``; the port computes with OIHW filters and ``[out, in]``
weights.  Both keep the JAX names.  Every other array (biases, norm
offsets and scales) is the same in both.  A round trip is exact.

:func:`state_to_jax` and :func:`state_from_jax` carry a whole trainer state
(params, optimiser state, the step) across the same boundary, as the plain
dict of the fields of the JAX package's ``AcganState``
(``ctgan_tpu/train/trainer_acgan.py:80-85``) or ``GANState``
(``ctgan_tpu/train/trainer_gan.py:67-72``), which have the same fields: its
train loop saves ``state._asdict()`` and restores ``type(state)(**blob["state"])``.
An optimiser state is a dict of per-parameter moment dicts (Adam's ``m``
and ``v``, RMSProp's ``ms`` and ``mom``) and scalars (Adam's ``t``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .train.trainer_acgan import AcganState
from .train.trainer_gan import GanState
from .utils.checkpoint import device_get

__all__ = ["from_jax_params", "to_jax_params", "state_to_jax", "state_from_jax"]


def _kind(name: str, ndim: int) -> str:
    if name.endswith(".Filters"):
        if ndim != 4:
            raise ValueError(f"{name}: only 2-D conv filters are bridged, got ndim={ndim}")
        return "filters"
    if name.endswith(".W"):
        if ndim != 2:
            raise ValueError(f"{name}: linear weights must be 2-D, got ndim={ndim}")
        return "weight"
    return "other"


def from_jax_params(params: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """JAX-layout arrays -> port-layout fp32 CPU tensors (contiguous)."""
    out = {}
    for name, value in params.items():
        t = torch.from_numpy(np.array(value, dtype=np.float32))
        kind = _kind(name, t.ndim)
        if kind == "filters":
            t = t.permute(3, 2, 0, 1)
        elif kind == "weight":
            t = t.t()
        out[name] = t.contiguous()
    return out


def _to_jax_layout(params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Port-layout tensors -> JAX-layout views on the same device."""
    out = {}
    for name, t in params.items():
        t = t.detach()
        kind = _kind(name, t.ndim)
        if kind == "filters":
            t = t.permute(2, 3, 1, 0)
        elif kind == "weight":
            t = t.t()
        out[name] = t
    return out


def to_jax_params(params: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Port-layout tensors (any device) -> JAX-layout NumPy arrays, copied
    to the host in one batch."""
    return device_get(_to_jax_layout(params))


def _opt_to_jax(opt: dict) -> dict:
    return {k: _to_jax_layout(v) if isinstance(v, Mapping) else np.array(v, np.float32)
            for k, v in opt.items()}


def state_to_jax(state: AcganState | GanState) -> dict:
    """The JAX package's state fields as NumPy arrays in its layouts:
    params and optimiser moment dicts, scalars such as Adam's ``t`` as 0-d
    float32, ``step`` as a 0-d int32, and nothing else."""
    return device_get({
        "gen_params": _to_jax_layout(state.gen_params),
        "disc_params": _to_jax_layout(state.disc_params),
        "gen_opt": _opt_to_jax(state.gen_opt),
        "disc_opt": _opt_to_jax(state.disc_opt),
        "step": np.array(state.step, np.int32),
    })


def _tensors(params: Mapping[str, np.ndarray], device, requires_grad: bool = False) -> dict:
    return {k: v.to(device).requires_grad_(requires_grad) for k, v in from_jax_params(params).items()}


def state_from_jax(blob_state: Mapping, device, cls: type = AcganState) -> AcganState | GanState:
    """A ``cls`` (``AcganState`` or ``GanState``) on ``device`` from the
    JAX-layout dict of :func:`state_to_jax` or of a JAX checkpoint's
    ``state``.  Params require grad, as the trainers' ``init_state`` makes
    them."""
    def opt(o):
        return {k: _tensors(v, device) if isinstance(v, Mapping) else float(np.asarray(v))
                for k, v in o.items()}

    return cls(
        _tensors(blob_state["gen_params"], device, True),
        _tensors(blob_state["disc_params"], device, True),
        opt(blob_state["gen_opt"]), opt(blob_state["disc_opt"]),
        int(np.asarray(blob_state["step"])),
    )
