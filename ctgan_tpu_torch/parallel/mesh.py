"""A ``data x model`` grid of processes, and the sharding rules
(counterpart of ``ctgan_tpu/parallel/mesh.py``).

The JAX package lays one ``jax.sharding.Mesh`` over the devices of one
program.  The port runs one process per GPU (``torchrun``), so its mesh is a
grid of ``torch.distributed`` ranks, ordered data-major as
``np.asarray(devices).reshape(data, model)`` orders devices: rank ``r`` sits
at data index ``r // model`` and model index ``r % model``.  Each rank
belongs to three groups: the whole mesh, its *data group* (the ranks of its
model column: the ``data`` axis) and its *model group* (the ranks of its data
row: the ``model`` axis).

* ``data`` axis: the batch is split over it (``shard_batch``).
* ``model`` axis: the leaves the rules match (``DEFAULT_RULES``: the
  generator's input projection, the critic's output head and embedding
  tables) are stored as shards along one dimension (``shard_params``); the
  training step gathers them (``parallel.spmd``).

A spec is a tuple of axis names or ``None``, one per dimension, in the place
of ``PartitionSpec``; ``()`` is replicated.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "DEFAULT_RULES",
    "Mesh",
    "data_sharding",
    "effective_param_specs",
    "make_mesh",
    "param_spec",
    "replicated",
    "shard_batch",
    "shard_params",
]

Spec = tuple


@dataclass(frozen=True)
class Mesh:
    """This process's place in a ``data x model`` grid of ranks, and the
    groups it belongs to; ``device`` is where its tensors live and
    ``backend`` the process group's (``nccl`` or ``gloo``)."""

    data: int
    model: int
    rank: int
    device: torch.device
    backend: str
    world_group: Any
    data_group: Any
    model_group: Any
    axis_names: tuple = ("data", "model")

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        if self.backend == "nccl":
            dist.barrier(group=self.world_group, device_ids=[self.device.index or 0])
        else:
            dist.barrier(group=self.world_group)


def _groups(data: int, model: int, rank: int) -> tuple:
    """(data group, model group) of ``rank``: every rank makes every group,
    in the same order, as ``new_group`` asks."""
    world = dist.group.WORLD
    columns = [world if model == 1 else dist.new_group([i * model + j for i in range(data)]) for j in range(model)]
    rows = [world if data == 1 else dist.new_group([i * model + j for j in range(model)]) for i in range(data)]
    return columns[rank % model], rows[rank // model]


def make_mesh(devices: Sequence | None = None, *, data: int | None = None, model: int = 1,
              device=None) -> Mesh:
    """The ``('data', 'model')`` grid over the ranks of the initialised
    default process group (``devices``, when given, must be one per rank).
    Default: all ranks on the data axis.  ``device``: this rank's device
    (the CPU for gloo, else ``cuda:<current device>``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group "
                           "(apps.common.maybe_mesh makes one from torchrun's environment)")
    n = dist.get_world_size()
    if devices is not None and len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} processes: a process drives one device")
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    backend = dist.get_backend()
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else torch.device("cpu")
    rank = dist.get_rank()
    data_group, model_group = _groups(data, model, rank)
    return Mesh(data, model, rank, torch.device(device), backend, dist.group.WORLD, data_group, model_group)


def data_sharding(mesh: Mesh, batch_axis: int = 0, ndim: int = 2) -> Spec:
    """The spec of a batch split over ``data`` along ``batch_axis``."""
    spec = [None] * ndim
    spec[batch_axis] = "data"
    return tuple(spec)


def replicated(mesh: Mesh) -> Spec:
    return ()


def _rows(x: torch.Tensor, axis: int, index: int, parts: int) -> torch.Tensor:
    n = x.shape[axis]
    if n % parts:
        raise ValueError(f"a batch of {n} does not split over {parts} ranks")
    return x.narrow(axis, index * (n // parts), n // parts)


def shard_batch(mesh: Mesh, batch, batch_axis: int = 0):
    """This rank's rows of a global host or device batch (a tensor, or a
    tuple or list of them), split over ``data``."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, b, batch_axis) for b in batch)
    return _rows(batch, batch_axis, mesh.data_index, mesh.data)


def local_rows(mesh: Mesh, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's rows of ``x`` split over every rank of the mesh (``data``
    and ``model``, data-major, as the JAX package shards a batch over
    ``('data', 'model')``)."""
    return _rows(x, axis, mesh.rank, mesh.world)


# Param-name regex -> spec.  Big generator input projections and critic flat
# output heads are the only large matrices of the model zoo; their wide
# dimension is split over 'model'.  The JAX rules' regexes, with the specs
# in the port's layout: a linear weight is [out, in] here (``bridge``), so
# JAX's (None, 'model') on [in, out] is ('model', None).
DEFAULT_RULES: tuple[tuple[str, Spec], ...] = (
    (r".*Generator\.Input\.W$", ("model", None)),
    (r".*Generator\.Input\.b$", ("model",)),
    (r".*Discriminator\.Output\.W$", (None, "model")),
    (r".*\.EmbeddingMatrix$", (None, "model")),
)


def param_spec(name: str, value, rules: Sequence[tuple[str, Spec]] = DEFAULT_RULES) -> Spec:
    for pattern, spec in rules:
        if re.fullmatch(pattern, name):
            return spec
    return ()


def effective_param_specs(mesh: Mesh, params: Mapping[str, torch.Tensor],
                          rules: Sequence[tuple[str, Spec]] = DEFAULT_RULES) -> dict[str, Spec]:
    """Per-leaf spec after the divisibility check: a rule applies only where
    the sharded dimension divides evenly by its axis, else the leaf stays
    replicated."""
    out = {}
    for k, v in params.items():
        spec = param_spec(k, v, rules)
        ok = all(axis is None or (dim < v.ndim and v.shape[dim] % mesh.shape.get(axis, 1) == 0)
                 for dim, axis in enumerate(spec))
        out[k] = spec if ok else ()
    return out


def model_dim(spec: Spec) -> int | None:
    """The dimension ``spec`` splits over ``model``, or None."""
    for dim, axis in enumerate(spec):
        if axis == "model":
            return dim
        if isinstance(axis, tuple) and "model" in axis:
            raise NotImplementedError(f"composite spec {spec} mixes 'model' with other axes; "
                                      "storage rules support plain 'model' entries only")
    return None


def shard_leaf(mesh: Mesh, value: torch.Tensor, spec: Spec) -> torch.Tensor:
    """This rank's shard of ``value`` under ``spec`` (a contiguous copy; the
    tensor itself where it is replicated)."""
    dim = model_dim(spec)
    if dim is None or mesh.model == 1:
        return value
    part = _rows(value.detach(), dim, mesh.model_index, mesh.model).clone()
    return part.requires_grad_(value.requires_grad)


def shard_params(mesh: Mesh, params: Mapping[str, torch.Tensor],
                 rules: Sequence[tuple[str, Spec]] = DEFAULT_RULES) -> dict[str, torch.Tensor]:
    """Each rule-matched leaf as this rank's shard along its model
    dimension; the rest as they are (replicated)."""
    specs = effective_param_specs(mesh, params, rules)
    return {k: shard_leaf(mesh, v, specs[k]) for k, v in params.items()}
