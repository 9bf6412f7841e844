"""Training loop with checkpoints, resume and a print/test/save cadence
(counterpart of ``ctgan_tpu/train/loop.py:37-292``).

* Resume restores ``(state, iteration, data state)`` from the newest
  ``ckpt_<N>.npz`` in ``ckpt_dir``.  The file is the JAX package's format,
  ``{"state": ..., "loop": {"iteration": N}, "data_state": ...}``, so a run
  resumes from a checkpoint that either package wrote.
* When the full checkpoints are gone, the small ``params_latest.npz`` that
  every save writes into the logger's ``out_dir`` gives an approximate
  resume: params exact, the step from the file, the optimizer's moments
  fresh (re-warmed from zero, a transient of about 1/(1-beta2) steps).
* :func:`ctgan_tpu_torch.utils.resume.guard_fresh_start` refuses to start
  behind the progress that ``log.pkl`` records.

The state crosses the file boundary through ``to_blob`` (state -> tree of
arrays, saved under ``"state"``) and ``from_blob`` (loaded tree -> state);
for the flagship they are ``bridge.state_to_jax`` and
``bridge.state_from_jax``.  ``step_fn(state, *batch, rand)`` returns
``(state, metrics)``, metrics a dict of 0-d tensors; it may update the
state in place.  Metrics stay on the device as one stacked tensor per
iteration and are copied to the host once per flush (``_Pending.drain``).

``LoopConfig.jit_step`` (default True, as the JAX field): when ``rand`` is a
``Randomness`` on a CUDA device, each iteration is one replay of a CUDA
graph (``train.capture.CapturedStep``: the first iteration or two run
eagerly as warm-up, the next is captured against the state's own tensors),
the counterpart of the JAX loop's ``jax.jit(step_fn, donate_argnums=0)``.
Such a ``step_fn`` updates the state in place, draws through
``rand.for_step(state.step)`` and advances ``state.step``; the tensors of a
``batch`` on the host reach it on the device.  ``jit_step=False`` and the
CPU run the step eagerly.  The metrics a replay returns are its static
outputs: ``_Pending.add`` copies them (``torch.stack`` on the same stream)
before the next replay overwrites them.

Over a mesh of processes (``mesh``, ``parallel``) every rank runs the loop
in lock step; only rank 0 logs (the others pass a quiet
logger) and writes checkpoints.  ``to_blob`` gathers the full leaves on
every rank (a collective), rank 0 writes them and every rank waits at a
barrier after the save; every rank reads a checkpoint to resume, and
``from_blob`` keeps its shard.  ``test_fn`` is called on every rank (the
app evaluates on rank 0).  The step runs as ``capture.step_runner`` says for
the mesh's backend.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..utils.checkpoint import _step_of, latest_checkpoint, load_checkpoint, save_checkpoint
from ..utils.debug import assert_finite
from ..utils.logging import MetricLogger
from ..utils.profiler import StepTimer, profile_step
from ..utils.resume import guard_fresh_start, reap_stale_tmps
from ..utils.watchdog import StepWatchdog
from . import capture
from .capture import CapturedStep

__all__ = ["LoopConfig", "train_loop"]


def _prune_checkpoints(ckpt_dir: str, keep: int, prefix: str = "ckpt") -> None:
    """Delete all but the newest ``keep`` checkpoints (by step).  Files
    whose step does not parse (``ckpt_best.npz``) stay; a pruned
    checkpoint's legacy ``.json`` sidecar goes with it."""
    cands = [f for f in os.listdir(ckpt_dir)
             if f.startswith(prefix) and f.endswith(".npz") and _step_of(f, prefix) is not None]
    for f in sorted(cands, key=lambda f: _step_of(f, prefix))[:-keep]:
        for path in (os.path.join(ckpt_dir, f), os.path.join(ckpt_dir, f) + ".json"):
            try:
                os.unlink(path)
            except OSError:
                pass


@dataclass
class LoopConfig:
    """The JAX ``LoopConfig``'s fields.  ``jit_step`` captures the step in a
    CUDA graph on the card (see the module's docstring)."""

    iters: int = 1000
    print_every: int = 100
    print_first: int = 5
    test_every: int | None = None
    save_every: int | None = None
    ckpt_dir: str | None = None
    resume: bool = True
    profile_iter: int | None = None
    profile_dir: str = "runs/ctgan_trace"
    nan_check_every: int | None = 100
    print_every_secs: float | None = None
    save_every_secs: float | None = None
    keep_checkpoints: int | None = None
    allow_fresh_start: bool = False
    jit_step: bool = True


def _identity(x):
    return x


class _Pending:
    """Each iteration's metrics as one stacked device tensor, until a
    flush copies them all to the host at once."""

    def __init__(self, logger: MetricLogger):
        self.logger = logger
        self.rows: list[tuple[list[str], torch.Tensor]] = []

    def add(self, metrics: dict) -> None:
        names = sorted(metrics)
        self.rows.append((names, torch.stack([metrics[k].detach().float() for k in names])))

    def drain(self) -> None:
        if not self.rows:
            return
        stacked = torch.stack([row for _, row in self.rows]).cpu().tolist()
        for (names, _), vals in zip(self.rows, stacked):
            for name, val in zip(names, vals):
                self.logger.plot(name, val)
        self.rows.clear()


def train_loop(
    state: Any,
    step_fn: Callable,
    next_batch: Callable[[], tuple],
    rand: Any,
    cfg: LoopConfig,
    *,
    logger: MetricLogger | None = None,
    test_fn: Callable[[Any, int], dict] | None = None,
    callback: Callable[[Any, int], None] | None = None,
    data_state: Callable[[], dict] | None = None,
    set_data_state: Callable[[dict], None] | None = None,
    to_blob: Callable[[Any], Any] = _identity,
    from_blob: Callable[[Any], Any] = _identity,
    mesh=None,
) -> Any:
    """Train from the newest checkpoint (or ``state``) to ``cfg.iters``;
    returns the final state.  ``rand`` is passed to every ``step_fn``
    call.  ``mesh``: the run's process grid (the module's docstring)."""
    if mesh is not None and cfg.save_every_secs:
        raise ValueError("save_every_secs over a mesh: the ranks' clocks would save at different iterations")
    logger = logger or MetricLogger()
    out_dir = logger.out_dir
    main = mesh is None or mesh.rank == 0
    if out_dir and main:
        reap_stale_tmps(out_dir)
    if cfg.ckpt_dir:
        os.makedirs(cfg.ckpt_dir, exist_ok=True)
        if main:
            reap_stale_tmps(cfg.ckpt_dir)

    start_iter = 0
    if cfg.resume and cfg.ckpt_dir:
        path = latest_checkpoint(cfg.ckpt_dir)
        if path:
            blob = load_checkpoint(path)
            state = from_blob(blob["state"])
            start_iter = int(blob["loop"]["iteration"])
            if set_data_state and blob.get("data_state"):
                set_data_state(blob["data_state"])
            if main:
                print(f"resumed from {path} at iteration {start_iter}")

    params_path = os.path.join(out_dir, "params_latest.npz") if out_dir else None
    if cfg.resume and start_iter == 0 and params_path and os.path.exists(params_path):
        fresh = to_blob(state)
        if isinstance(fresh, dict):
            blob = load_checkpoint(params_path)
            it = int(blob["iteration"])
            fresh.update({k: v for k, v in blob["params"].items() if k in fresh})
            if "step" in fresh:
                fresh["step"] = it
            state = from_blob(fresh)
            start_iter = it
            if main:
                print(f"resumed (approximate) from {params_path} at iteration {it}: "
                      f"params exact, optimizer re-warmed")

    if out_dir and cfg.ckpt_dir:
        # logs flush more often than checkpoints: a legitimate resume can
        # trail the log by up to one save interval
        guard_fresh_start(out_dir, start_iter, allow_fresh_start=cfg.allow_fresh_start,
                          tolerance=cfg.save_every or 1000)

    logger.set_iteration(start_iter)
    pending = _Pending(logger)
    run_step = _step_runner(step_fn, rand, cfg, mesh)
    watchdog = StepWatchdog.start_from_env(name="train_loop")
    try:
        state = _train_iterations(
            state, run_step, next_batch, cfg, logger, start_iter, pending, watchdog,
            test_fn=test_fn, callback=callback, data_state=data_state, to_blob=to_blob, mesh=mesh,
        )
    finally:
        watchdog.stop()

    pending.drain()
    # the iterations since the last cadence flush, labelled by the last one
    if logger.pending:
        logger.set_iteration(logger.iteration - 1)
        logger.flush()
    return state


def _save(cfg: LoopConfig, logger: MetricLogger, state, iteration: int, data_state, to_blob, mesh=None):
    blob_state = to_blob(state)  # every rank: the full leaves are gathered
    if mesh is not None and mesh.rank != 0:
        mesh.barrier()
        return
    save_checkpoint(os.path.join(cfg.ckpt_dir, f"ckpt_{iteration + 1}.npz"), {
        "state": blob_state,
        "loop": {"iteration": iteration + 1},
        "data_state": data_state() if data_state else None,
    })
    if cfg.keep_checkpoints:
        _prune_checkpoints(cfg.ckpt_dir, cfg.keep_checkpoints)
    # the small params snapshot beside the log: the approximate-resume
    # source when the checkpoint directory is lost
    if logger.out_dir and isinstance(blob_state, dict):
        params = {k: v for k, v in blob_state.items() if k.endswith("_params")}
        if params:
            save_checkpoint(os.path.join(logger.out_dir, "params_latest.npz"),
                            {"params": params, "iteration": iteration + 1})
    if mesh is not None:
        mesh.barrier()


def _step_runner(step_fn: Callable, rand, cfg: LoopConfig, mesh=None) -> Callable:
    """``run(state, batch) -> (state, metrics)``: the captured step where
    ``cfg.jit_step`` and ``rand`` runs on the card, else ``step_fn``
    eagerly."""
    run = capture.step_runner(step_fn, rand, name=getattr(step_fn, "__qualname__", "step_fn"),
                              jit_step=cfg.jit_step, mesh=mesh)
    if not isinstance(run, CapturedStep):
        return lambda state, batch: run(state, *batch)

    def run_captured(state, batch):
        new_state, metrics = run(state, *batch)
        if new_state is not state:
            raise RuntimeError(f"{run.name}: a captured step updates its state in place")
        return new_state, metrics

    return run_captured


def _train_iterations(state, run_step, next_batch, cfg, logger, start_iter, pending,
                      watchdog, *, test_fn, callback, data_state, to_blob, mesh):
    timer = StepTimer()
    last_print = last_save = time.time()
    for iteration in range(start_iter, cfg.iters):
        with timer.data():
            batch = next_batch()
        if cfg.profile_iter is not None and iteration == cfg.profile_iter:
            with profile_step(cfg.profile_dir):
                state, metrics = run_step(state, batch)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        else:
            state, metrics = run_step(state, batch)

        pending.add(metrics)
        if cfg.nan_check_every and iteration % cfg.nan_check_every == 0:
            pending.drain()
            assert_finite(metrics, f"metrics at iteration {iteration}")
        total, data_t = timer.lap()
        logger.plot("time", total)
        logger.plot("data time", data_t)

        on_test = bool(cfg.test_every) and iteration % cfg.test_every == cfg.test_every - 1
        if test_fn and on_test:
            for name, val in test_fn(state, iteration).items():
                logger.plot(name, val)
        if callback and on_test:
            callback(state, iteration)

        save_now = bool(cfg.save_every and iteration % cfg.save_every == cfg.save_every - 1)
        if cfg.save_every_secs and time.time() - last_save >= cfg.save_every_secs:
            save_now = True
        if cfg.ckpt_dir and save_now:
            last_save = time.time()
            _save(cfg, logger, state, iteration, data_state, to_blob, mesh)

        print_now = iteration < cfg.print_first or iteration % cfg.print_every == cfg.print_every - 1
        if cfg.print_every_secs and time.time() - last_print >= cfg.print_every_secs:
            print_now = True
        if print_now:
            last_print = time.time()
            pending.drain()
            logger.flush()
        logger.tick()
        watchdog.beat()
    return state
