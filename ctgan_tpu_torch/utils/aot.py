"""Ahead-of-time serving programs: save, load, validate (counterpart of
``ctgan_tpu/utils/aot.py``).

The artifact is a ``torch.export`` program of G's forward at one serving
batch (``torch.export.save``'s archive), with a record beside it in the
archive (``extra/ctgan_aot.json``): a magic string, the environment that
exported it (torch version, device name, platform) and ``meta`` (the
caller's: model, batch, dim, bf16).  The program's inputs are G's params,
the noise and, for a conditional G, the labels, so the artifact is
weight-independent: one artifact serves every checkpoint of its model, as in
the JAX package.  (``torch.export`` also keeps the example inputs it was
traced with in the archive; they are not used.)  The draws stay outside the
program, so a caller makes them as the eager path does.

A loaded program runs with no Python of the model and no tracing; it is
specific to the torch version, the device and the traced shapes.
:func:`load_aot` checks the first two against the record before it
deserialises anything and fails with advice instead of a crash.
"""

from __future__ import annotations

import json
import os
import platform
import sys
import time
import zipfile
from typing import Callable

import torch

__all__ = ["AotMismatch", "RECORD", "env_meta", "load_aot", "read_record", "save_aot"]

_MAGIC = "ctgan-tpu-torch-aot-v1"
RECORD = "ctgan_aot.json"  # the record's name among the archive's extra files


class AotMismatch(RuntimeError):
    """The AOT artifact cannot run here (not an artifact, another torch
    version, device or platform)."""


def env_meta(device) -> dict:
    """What an exported program depends on: the torch version, the device's
    name and its platform (``cuda`` or ``cpu``)."""
    device = torch.device(device)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
    else:
        name = platform.machine() or "cpu"
    return {"torch_version": torch.__version__, "device_name": name, "platform": device.type}


def save_aot(path: str, program: "torch.export.ExportedProgram", device, meta: dict | None = None) -> dict:
    """Write ``program`` (exported on ``device``) and its record to
    ``path`` through ``<path>.tmp`` and an atomic rename; returns the
    environment and ``meta`` written."""
    record = {"magic": _MAGIC, "env": env_meta(device), "meta": dict(meta or {})}
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:  # a file object: torch.export.save names no archive after ".tmp"
        torch.export.save(program, fh, extra_files={RECORD: json.dumps(record)})
    os.replace(tmp, path)
    return {**record["env"], **record["meta"]}


def read_record(path: str) -> dict:
    """The record of the artifact at ``path``, read without deserialising
    the program; :class:`AotMismatch` when ``path`` is not an artifact."""
    try:
        with zipfile.ZipFile(path) as zf:
            name = next((n for n in zf.namelist() if n.endswith(f"/extra/{RECORD}")), None)
            record = json.loads(zf.read(name)) if name else {}
    except (OSError, zipfile.BadZipFile, ValueError) as err:
        raise AotMismatch(f"{path} is not a {_MAGIC} artifact ({err})") from err
    if record.get("magic") != _MAGIC:
        raise AotMismatch(f"{path} is not a {_MAGIC} artifact")
    return record


def load_aot(path: str, strict: bool = True, device="cuda") -> tuple[Callable, dict]:
    """``(program, meta)`` of the artifact at ``path``, to run on ``device``.

    ``strict=True`` raises :class:`AotMismatch` when the recorded torch
    version, device name or platform differ from this process's
    ``device`` (a mismatched program may fail or compute otherwise);
    ``strict=False`` warns on stderr instead.  ``meta["load_sec"]`` is the
    seconds the load took (reading, checking, deserialising)."""
    t0 = time.perf_counter()
    record = read_record(path)
    env, here = record["env"], env_meta(device)
    mismatches = {k: (env.get(k), here[k]) for k in ("torch_version", "device_name", "platform")
                  if env.get(k) != here[k]}
    if mismatches:
        msg = (f"AOT artifact {path} was built for a different environment: "
               + ", ".join(f"{k}={a!r} (here {b!r})" for k, (a, b) in mismatches.items())
               + ". Rebuild with --aot_save on this environment, or serve eagerly (without --aot).")
        if strict:
            raise AotMismatch(msg)
        print(f"warning: {msg}", file=sys.stderr)
    program = torch.export.load(path).module()
    meta = {**record["meta"], "env": env, "load_sec": round(time.perf_counter() - t0, 3)}
    return program, meta
