"""A small launcher for a group of ranks on one host: one spawned process
per rank, joined over a ``FileStore`` in a private temporary directory (no
ports), NCCL with one card each or gloo on the CPU.

Every collective waits at most ``join_timeout`` seconds (the process
group's timeout), and the whole group at most ``timeout``.  A rank that
raises, exits or outlives the group's deadline ends the group: every rank
still running is killed, and the call raises with the ranks' tracebacks.
No process outlives the call.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable

import torch
import torch.distributed as dist

__all__ = ["run_ranks"]


def run_ranks(world: int, fn: Callable, args: tuple = (), *, backend: str, timeout: float = 600.0,
              join_timeout: float = 120.0) -> list:
    """``[fn(rank, world, *args) for each rank]``, each call in its own
    process inside an initialised ``torch.distributed`` group of ``world``
    ranks (``backend`` ``"nccl"``: rank ``r`` on ``cuda:r``; ``"gloo"``:
    the CPU, one thread a rank).  ``fn`` must be importable by name (a
    module-level function) and return something picklable."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if backend == "nccl" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} NCCL ranks run one process per card: {world} cards needed, "
                           f"{torch.cuda.device_count()} visible")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ctgan_ranks_") as tmp:
        outs = [os.path.join(tmp, f"rank{rank}") for rank in range(world)]
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, world, backend, os.path.join(tmp, "store"), join_timeout, fn, args,
                                   outs[rank]))
                 for rank in range(world)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            while any(p.is_alive() for p in procs):
                if time.monotonic() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.pid is None:  # never started
                    continue
                if p.is_alive():
                    p.kill()
                p.join()
        errors = [Path(out + ".err").read_text() for out in outs if os.path.exists(out + ".err")]
        codes = [p.exitcode for p in procs]
        if errors or any(codes):
            late = " (killed at the group's deadline)" if time.monotonic() > deadline else ""
            raise RuntimeError(f"{world} {backend} ranks failed: exit codes {codes}{late}\n" + "\n".join(errors))
        return [pickle.loads(Path(out + ".pkl").read_bytes()) for out in outs]


def _rank_main(rank: int, world: int, backend: str, store: str, join_timeout: float, fn: Callable, args: tuple,
               out: str) -> None:
    try:
        kw = {}
        if backend == "nccl":
            torch.cuda.set_device(rank)
            kw["device_id"] = torch.device("cuda", rank)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=join_timeout), **kw)
        Path(out + ".pkl").write_bytes(pickle.dumps(fn(rank, world, *args)))
    except BaseException:
        Path(out + ".err").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
