"""The one place where parameters change layout between the two packages.

The JAX package stores conv filters as HWIO and linear weights as
``[in, out]``; the port computes with OIHW filters and ``[out, in]``
weights.  Both keep the JAX names.  A weight-normed layer's 4-D ``.W``
is a filter like ``.Filters`` (a transposed conv's HWOI becomes ``[in, out,
kH, kW]``), its 2-D one a linear weight.  Every other array (biases, norm
offsets and scales, weight-norm gains) is the same in both.  A round trip
is exact.

:func:`state_to_jax` and :func:`state_from_jax` carry a whole trainer state
(params, optimiser state, the step) across the same boundary, as the plain
dict of the fields of the JAX package's ``AcganState``
(``ctgan_tpu/train/trainer_acgan.py:80-85``) or ``GANState``
(``ctgan_tpu/train/trainer_gan.py:67-72``), which have the same fields, or
``SslState`` (``ctgan_tpu/train/trainer_semisup.py:48-54``, with
``avg_params``): the JAX package saves ``state._asdict()`` and restores
``type(state)(**blob["state"])``.
An optimiser state is a dict of per-parameter moment dicts (Adam's ``m``
and ``v``, RMSProp's ``ms`` and ``mom``, Nadam's ``m`` and ``v``,
Adamax's ``m`` and ``u``, momentum's ``mom``) and scalars (``t``).
Moments stored in bf16 (``train.optim.with_state_dtype``) cross as their
bits: a ``|V2`` array (``utils.checkpoint``) on the NumPy side, bf16 on
the port's.

The layouts by name and rank (:func:`_kind`):

* ``.Filters``: a conv's, 4-D HWIO to OIHW, or ``conv1d``'s, 3-D ``[W,
  in, out]`` to ``[out, in, W]``;
* ``.W``: 2-D a linear weight, ``[in, out]`` to ``[out, in]`` (the
  recurrent cells' ``.Gates.W``, ``.Candidate.W`` and ``.InputToHidden.W``,
  an MLP's layers), 4-D a weight-normed conv's filter as ``.Filters``;
* ``.PointwiseFilters``: a separable conv's 1x1 HWIO to OIHW;
* ``.DepthwiseFilters``: ``[kh, kw, in, mult]`` to ``[in, mult, kh, kw]``,
  which ``ops.conv.separable_conv2d`` reads as the grouped filter ``[in *
  mult, 1, kh, kw]`` (a view); stored apart, ``in`` and ``mult`` stay
  known, so the way back is exact;
* everything else as it is (an ``.EmbeddingMatrix``, a minibatch layer's
  3-D ``.theta``, biases, gains, norm parameters).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .train.trainer_acgan import AcganState
from .train.trainer_gan import GanState
from .train.trainer_semisup import SslState
from .utils.checkpoint import as_tensor, device_get, is_bf16_bits

__all__ = ["from_jax_params", "to_jax_params", "state_to_jax", "state_from_jax"]


def _kind(name: str, ndim: int) -> str:
    if name.endswith(".Filters"):
        if ndim not in (3, 4):
            raise ValueError(f"{name}: conv filters are 3-D (conv1d) or 4-D (conv2d), got ndim={ndim}")
        return "filters" if ndim == 4 else "filters1d"
    if name.endswith(".PointwiseFilters"):
        if ndim != 4:
            raise ValueError(f"{name}: a pointwise filter is 4-D, got ndim={ndim}")
        return "filters"
    if name.endswith(".DepthwiseFilters"):
        if ndim != 4:
            raise ValueError(f"{name}: a depthwise filter is 4-D, got ndim={ndim}")
        return "depthwise"
    if name.endswith(".W"):
        # a weight-normed conv's or transposed conv's W is a 4-D filter
        if ndim not in (2, 4):
            raise ValueError(f"{name}: weights must be 2-D (linear) or 4-D (conv), got ndim={ndim}")
        return "weight" if ndim == 2 else "filters"
    return "other"


# the permutation of each layout kind; each but "filters" is its own inverse
_TO_PORT = {"filters": (3, 2, 0, 1), "filters1d": (2, 1, 0), "depthwise": (2, 3, 0, 1), "weight": (1, 0)}
_TO_JAX = dict(_TO_PORT, filters=(2, 3, 1, 0))


def _leaf(value) -> torch.Tensor:
    """A fresh CPU tensor of a JAX-side leaf: fp32, or bf16 for a bf16
    leaf (``|V2`` bits)."""
    a = np.asarray(value)
    return as_tensor(np.array(a)) if is_bf16_bits(a) else torch.from_numpy(np.array(a, dtype=np.float32))


def from_jax_params(params: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """JAX-layout arrays -> port-layout fp32 (bf16 for a bf16 leaf) CPU
    tensors (contiguous)."""
    out = {}
    for name, value in params.items():
        t = _leaf(value)
        kind = _kind(name, t.ndim)
        if kind != "other":
            t = t.permute(*_TO_PORT[kind])
        out[name] = t.contiguous()
    return out


def _to_jax_layout(params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Port-layout tensors -> JAX-layout views on the same device."""
    out = {}
    for name, t in params.items():
        t = t.detach()
        kind = _kind(name, t.ndim)
        if kind != "other":
            t = t.permute(*_TO_JAX[kind])
        out[name] = t
    return out


def to_jax_params(params: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Port-layout tensors (any device) -> JAX-layout NumPy arrays, copied
    to the host in one batch (bf16 ones as ``|V2`` bits)."""
    return device_get(_to_jax_layout(params))


def _opt_to_jax(opt: dict) -> dict:
    return {k: _to_jax_layout(v) if isinstance(v, Mapping) else np.array(v, np.float32)
            for k, v in opt.items()}


def state_to_jax(state: AcganState | GanState | SslState) -> dict:
    """The JAX package's state fields as NumPy arrays in its layouts:
    params (``*_params``) and optimiser moment dicts (``*_opt``), scalars
    such as Adam's ``t`` as 0-d float32, ``step`` as a 0-d int32, and
    nothing else."""
    out = {}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if f.name == "step":
            out[f.name] = np.array(value, np.int32)
        elif f.name.endswith("_opt"):
            out[f.name] = _opt_to_jax(value)
        else:
            out[f.name] = _to_jax_layout(value)
    return device_get(out)


def _tensors(params: Mapping[str, np.ndarray], device, requires_grad: bool = False) -> dict:
    return {k: v.to(device).requires_grad_(requires_grad) for k, v in from_jax_params(params).items()}


def state_from_jax(blob_state: Mapping, device,
                   cls: type = AcganState) -> AcganState | GanState | SslState:
    """A ``cls`` (``AcganState``, ``GanState`` or ``SslState``) on
    ``device`` from the JAX-layout dict of :func:`state_to_jax` or of a JAX
    checkpoint's ``state``.  G's and D's params require grad, as the
    trainers' ``init_state`` makes them (an ``SslState``'s ``avg_params``
    do not)."""
    def opt(o):
        return {k: _tensors(v, device) if isinstance(v, Mapping) else float(np.asarray(v))
                for k, v in o.items()}

    fields = {}
    for f in dataclasses.fields(cls):
        value = blob_state[f.name]
        if f.name == "step":
            fields[f.name] = int(np.asarray(value))
        elif f.name.endswith("_opt"):
            fields[f.name] = opt(value)
        else:
            fields[f.name] = _tensors(value, device, f.name in ("gen_params", "disc_params"))
    return cls(**fields)
