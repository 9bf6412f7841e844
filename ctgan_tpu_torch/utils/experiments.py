"""Experiment-management helpers (own copy of
``ctgan_tpu/utils/experiments.py``, the reference's
``Theano_classifier/utils.py:30-165``): attribute-style config dicts,
numbered results directories, the best parameters' snapshot, the
experiment's parameters as JSON, ``MetricLogger``'s log as columns, and a
compact channel printer.

Checkpoints go through :func:`utils.checkpoint.save_checkpoint` in the JAX
layout (``bridge.to_jax_params``), so one ``trained_params.npz`` loads in
both packages.  A snapshot is a host copy: the port's optimisers update
parameters in place, and a captured step reuses its buffers, so an array
that shares a live tensor's memory would follow every later step.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import numpy as np
import torch

from .checkpoint import as_tensor, save_checkpoint

__all__ = [
    "AttributeDict", "prepare_dir", "BestParamSaver", "save_exp_params",
    "load_exp_params", "load_log", "short_format", "filter_funcs_prefix",
]


class AttributeDict(dict):
    """A dict whose keys read and write as attributes
    (Theano_classifier/utils.py:23-27)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value


def prepare_dir(save_to: str, results_dir: str = "results") -> str:
    """Create and return the first free ``<results_dir>/<save_to><i>``,
    ``i`` from 0 (utils.py:141-153); ``os.makedirs`` decides, so two
    processes never take the same one."""
    base = os.path.join(results_dir, save_to)
    i = 0
    while True:
        name = f"{base}{i}"
        try:
            os.makedirs(name)
            return name
        except FileExistsError:
            i += 1


def _host_snapshot(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """JAX-layout host copies of port-layout parameters (tensors on any
    device, or arrays)."""
    from ..bridge import to_jax_params  # here: the bridge imports this package's checkpoint module

    return to_jax_params({k: v if isinstance(v, torch.Tensor) else as_tensor(v) for k, v in params.items()})


class BestParamSaver:
    """Track a scalar channel and keep the best parameters' snapshot
    (utils.py:86-114 ``SaveParams``).

    ``update(value, params)`` after each evaluation; ``save()`` writes the
    best snapshot (with ``track=False``, the latest) to
    ``<save_path>/trained_params.npz``.  Call ``save()`` from a ``finally:``
    block, as the reference saved after training and on an interrupt.
    """

    def __init__(self, save_path: str, *, minimize: bool = True, track: bool = True):
        self.save_path = save_path
        self.minimize = minimize
        self.track = track
        self.best_value: float | None = None
        self._snapshot: dict[str, np.ndarray] | None = None

    def update(self, value: float | None, params: Mapping[str, Any]) -> bool:
        """Record an evaluation (``None``: skipped, the best snapshot
        stays); returns whether it is a new best."""
        if not self.track:
            self._snapshot = _host_snapshot(params)
            return False
        if value is None:
            return False
        value = float(value)
        better = (self.best_value is None
                  or (value < self.best_value if self.minimize else value > self.best_value))
        if better:
            self.best_value = value
            self._snapshot = _host_snapshot(params)
        return better

    def save(self) -> str | None:
        if self._snapshot is None:
            return None
        return save_checkpoint(os.path.join(self.save_path, "trained_params.npz"), dict(self._snapshot))


def save_exp_params(out_dir: str, params: Mapping[str, Any]) -> str:
    """Write the experiment's configuration to ``<out_dir>/params.json``
    atomically (utils.py:117-126)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "params.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({k: _jsonable(v) for k, v in params.items()}, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_exp_params(out_dir: str) -> AttributeDict:
    with open(os.path.join(out_dir, "params.json")) as f:
        return AttributeDict(json.load(f))


def _jsonable(v):
    if isinstance(v, (np.integer, np.floating)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def load_log(out_dir: str, filename: str = "log.ndjson") -> dict[str, list]:
    """``MetricLogger``'s ndjson log as columns, keys sorted (utils.py:156-159
    ``load_df``, a dict of lists for a DataFrame); a row without a channel
    gives NaN there."""
    rows = []
    with open(os.path.join(out_dir, filename)) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    keys = sorted({k for r in rows for k in r})
    return {k: [r.get(k, float("nan")) for r in rows] for k in keys}


def short_format(epoch: int, iteration: int, row: Mapping[str, float],
                 to_print: Mapping[str, str | list[str]]) -> str:
    """One line of channels (utils.py:42-84 ``ShortPrinting``): ``to_print``
    maps a short name to a channel or a list of them; channels missing from
    ``row`` are skipped, as the reference skipped them."""
    items = []
    for short, chans in to_print.items():
        if chans is None:
            continue
        if not isinstance(chans, (list, tuple)):
            chans = [chans]
        vals = [row[c] for c in chans if c in row]
        if vals:
            items.append(short + " " + " ".join(f"{v:.3g}" for v in vals))
    return f"e {epoch}, i {iteration}: " + ", ".join(items)


def filter_funcs_prefix(d: Mapping[str, Any], pfx: str = "cmd_") -> dict[str, Any]:
    """The entries whose name contains ``pfx``, named by what follows it
    (utils.py:162-165, which ignored its argument and always used
    ``cmd_``)."""
    out = {}
    for name, v in d.items():
        i = name.find(pfx)
        if i >= 0:
            out[name[i + len(pfx):]] = v
    return out
