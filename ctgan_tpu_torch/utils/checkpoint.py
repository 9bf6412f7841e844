"""Atomic checkpoints in the JAX package's ``.npz`` format (own copy of
``ctgan_tpu/utils/checkpoint.py``, which cannot be imported without JAX).

One checkpoint is one ``.npz``: every array leaf of a nested
dict/namedtuple/list/tuple tree under its ``/``-joined path, plus the
tree's structure as JSON in the uint8 array ``__structure_json__``.  It is
written to a temporary file in the same directory, flushed to disk and
renamed into place, so a reader sees the old file or the new one, never
half of one.  Either package reads what the other writes; the structure
JSON is the same (``dict``, ``namedtuple``, ``list``, ``tuple``, ``none``,
``scalar``, ``array``).  Checkpoints of the JAX package's first round kept
the structure in a sidecar ``<path>.json``; those are still read.

Tensors leave the device in one batched copy per dtype (:func:`device_get`),
not one synchronising copy per tensor.

bf16 leaves (optimiser moments under ``with_state_dtype``) are written as
the JAX package writes them: NumPy has no bfloat16, so ``np.savez`` stores
the JAX package's bf16 array as its raw 16-bit patterns, dtype ``|V2``, and
``np.load`` gives back ``|V2``.  :func:`device_get` turns a bf16 tensor into
that ``|V2`` array, and :func:`as_tensor` reads one (or a bfloat16 array of
``ml_dtypes``, which is also 2-byte void to NumPy) back as a bf16 tensor:
the same bits both ways.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["as_tensor", "device_get", "is_bf16_bits", "save_checkpoint", "load_checkpoint", "latest_checkpoint"]

_SEP = "/"
_STRUCT_KEY = "__structure_json__"
BF16_BITS = np.dtype("V2")  # how NumPy stores a bf16 array: its raw 16-bit patterns


def is_bf16_bits(a: np.ndarray) -> bool:
    """Whether ``a`` holds bf16 values as 2-byte patterns (``|V2``, or the
    bfloat16 of ``ml_dtypes``)."""
    return a.dtype.kind == "V" and a.dtype.itemsize == 2 and a.dtype.names is None


def as_tensor(a) -> torch.Tensor:
    """A CPU tensor of the array ``a`` (shared, or a copy where ``a`` is
    read-only): a ``|V2`` (or ``ml_dtypes`` bfloat16) array as bf16 with its
    bits, anything else as ``torch.from_numpy`` makes it."""
    a = np.asarray(a)
    a = np.ascontiguousarray(a) if a.flags.writeable else np.array(a)
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) if is_bf16_bits(a) else torch.from_numpy(a)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's values; a bf16 tensor's bits as ``|V2``."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_BITS)
    return t.numpy()


def _map_tensors(tree: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """``tree`` with every tensor leaf replaced by ``fn(leaf)``, visited in
    a fixed order (dict insertion order, then sequence order)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_tensors(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def device_get(tree: Any) -> Any:
    """``tree`` with every tensor replaced by a NumPy array of its values
(a bf16 tensor by its bits, ``|V2``).

    The tensors of one device and dtype are flattened, joined on their
    device and copied to the host together, so a state of a few hundred
    tensors costs one transfer per dtype.  The arrays own their memory
    apart from the tensors."""
    tensors: list[torch.Tensor] = []
    _map_tensors(tree, tensors.append)
    groups: dict[tuple, list[int]] = defaultdict(list)
    for i, t in enumerate(tensors):
        groups[(t.device, t.dtype)].append(i)
    host: list[np.ndarray | None] = [None] * len(tensors)
    for idx in groups.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx]).cpu()
        pieces = flat.split([tensors[i].numel() for i in idx])
        for i, piece in zip(idx, pieces):
            host[i] = _numpy(piece.reshape(tensors[i].shape))
    leaves = iter(host)
    return _map_tensors(tree, lambda _: next(leaves))


def _flatten(tree: Any, prefix: str = "") -> tuple[dict, Any]:
    """Name -> array of the tree's array leaves, and its structure."""
    def child(k):
        return f"{prefix}{_SEP}{k}" if prefix else str(k)

    if isinstance(tree, dict):
        arrays, struct = {}, {"__kind__": "dict", "items": {}}
        for k in sorted(tree):
            a, s = _flatten(tree[k], child(k))
            arrays.update(a)
            struct["items"][k] = s
        return arrays, struct
    if hasattr(tree, "_fields"):  # namedtuple
        arrays, struct = {}, {
            "__kind__": "namedtuple", "cls": type(tree).__name__,
            "fields": list(tree._fields), "items": {},
        }
        for k in tree._fields:
            a, s = _flatten(getattr(tree, k), child(k))
            arrays.update(a)
            struct["items"][k] = s
        return arrays, struct
    if isinstance(tree, (list, tuple)):
        arrays, struct = {}, {"__kind__": "list" if isinstance(tree, list) else "tuple", "items": []}
        for i, v in enumerate(tree):
            a, s = _flatten(v, child(i))
            arrays.update(a)
            struct["items"].append(s)
        return arrays, struct
    if tree is None:
        return {}, {"__kind__": "none"}
    if isinstance(tree, (str, bool)):
        return {}, {"__kind__": "scalar", "value": tree}
    if isinstance(tree, (int, float)) and not isinstance(tree, np.generic):
        return {}, {"__kind__": "scalar", "value": tree}
    return {prefix: np.asarray(tree)}, {"__kind__": "array", "name": prefix}


def _unflatten(struct: Any, arrays: dict) -> Any:
    kind = struct["__kind__"]
    if kind in ("dict", "namedtuple"):
        # a namedtuple comes back as a dict keyed by field: callers rebuild
        # their own types, so a checkpoint does not depend on a class
        return {k: _unflatten(s, arrays) for k, s in struct["items"].items()}
    if kind == "list":
        return [_unflatten(s, arrays) for s in struct["items"]]
    if kind == "tuple":
        return tuple(_unflatten(s, arrays) for s in struct["items"])
    if kind == "none":
        return None
    if kind == "scalar":
        return struct["value"]
    return arrays[struct["name"]]


def save_checkpoint(path: str, tree: Any) -> str:
    """Atomically write ``tree`` (NumPy arrays, tensors on any device,
    Python scalars, strings and ``None`` in dicts, namedtuples, lists and
    tuples) to ``path`` as one self-contained ``.npz``."""
    dir_ = os.path.dirname(path) or "."
    os.makedirs(dir_, exist_ok=True)
    arrays, struct = _flatten(device_get(tree))
    if _STRUCT_KEY in arrays:
        raise ValueError(f"reserved key {_STRUCT_KEY!r} in tree")
    struct_bytes = np.frombuffer(json.dumps(struct).encode("utf-8"), dtype=np.uint8)
    fd, tmp = tempfile.mkstemp(dir=dir_, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **{_STRUCT_KEY: struct_bytes}, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(path: str) -> Any:
    """The tree saved at ``path``, with NumPy arrays as leaves."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    embedded = arrays.pop(_STRUCT_KEY, None)
    if embedded is not None:
        struct = json.loads(bytes(embedded).decode("utf-8"))
    else:
        with open(path + ".json") as f:
            struct = json.load(f)
    return _unflatten(struct, arrays)


def _step_of(filename: str, prefix: str) -> int | None:
    """The step of ``<prefix>_<step>.npz``, or None if it does not parse."""
    try:
        return int(filename[len(prefix) + 1 : -4])
    except ValueError:
        return None


def latest_checkpoint(dir_: str, prefix: str = "ckpt") -> str | None:
    """The checkpoint in ``dir_`` with the highest step, or None."""
    if not os.path.isdir(dir_):
        return None
    cands = [f for f in os.listdir(dir_) if f.startswith(prefix) and f.endswith(".npz")]
    if not cands:
        return None
    def key(f):
        step = _step_of(f, prefix)
        return -1 if step is None else step

    return os.path.join(dir_, max(cands, key=key))
