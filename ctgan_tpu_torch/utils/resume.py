"""Resume safety (own copy of ``ctgan_tpu/utils/resume.py:43-172``).

* :func:`guard_fresh_start` refuses to train from iteration S in a
  directory whose ``log.pkl`` records progress beyond S (plus a tolerance,
  the save cadence), unless ``allow_fresh_start`` or
  ``$CTGAN_ALLOW_FRESH_START=1``: the full checkpoints are gone or stale,
  and starting over would overwrite the logged work.
* :func:`reap_stale_tmps` deletes the temporary files that an atomic
  checkpoint write leaves when its process is killed.
* :func:`logged_progress` is the highest iteration in ``log.pkl``.

* :func:`resolve_ssl_resume` picks the semi-supervised apps' resume
  source: the full state ``ssl_state.npz`` (exact), else the tracked
  ``disc_params.npz`` / ``gen_params.npz`` (and ``avg_params.npz``) with
  the epoch from ``log.pkl`` (approximate: params exact, optimiser and
  averages re-warmed), else a guarded fresh start.

The GAN apps' approximate resume from ``params_latest.npz`` lives in
``train.loop.train_loop``.
"""

from __future__ import annotations

import glob
import os
import pickle
import zipfile

__all__ = ["guard_fresh_start", "logged_progress", "reap_stale_tmps", "resolve_ssl_resume"]


def _allow_fresh_env() -> bool:
    return os.environ.get("CTGAN_ALLOW_FRESH_START", "").strip().lower() in ("1", "true", "yes")


def logged_progress(out_dir: str) -> int:
    """Highest iteration recorded in ``out_dir/log.pkl`` (0 if none or
    unreadable)."""
    path = os.path.join(out_dir, "log.pkl")
    if not os.path.exists(path):
        return 0
    try:
        with open(path, "rb") as f:
            history = pickle.load(f)
    except (OSError, EOFError, pickle.UnpicklingError, AttributeError, TypeError, ValueError):
        return 0
    best = 0
    for series in history.values():
        if series:
            best = max(best, max(series))
    return int(best)


def reap_stale_tmps(out_dir: str) -> list[str]:
    """Delete ``*.npz.tmp`` files in ``out_dir``; returns their paths."""
    reaped = []
    for path in glob.glob(os.path.join(out_dir, "*.npz.tmp")):
        try:
            os.unlink(path)
            reaped.append(path)
        except OSError:
            pass
    if reaped:
        print(f"reaped {len(reaped)} stale checkpoint tmp file(s): " + ", ".join(reaped))
    return reaped


def guard_fresh_start(out_dir: str, start_iteration: int, *, allow_fresh_start: bool = False,
                      tolerance: int = 0, unit: str = "iteration") -> None:
    """Raise ``SystemExit`` when ``out_dir``'s log records more progress
    than ``start_iteration + tolerance``."""
    if allow_fresh_start or _allow_fresh_env():
        return
    prior = logged_progress(out_dir)
    if prior > start_iteration + tolerance:
        raise SystemExit(
            f"REFUSING to train from {unit} {start_iteration}: "
            f"{out_dir}/log.pkl records progress to {unit} {prior}. "
            f"The resume state this directory once had is gone or stale: "
            f"starting now would overwrite {prior - start_iteration} {unit}s of work. "
            f"Restore the checkpoint, point --out_dir elsewhere, or pass "
            f"--allow_fresh_start true (env CTGAN_ALLOW_FRESH_START=1) to proceed deliberately."
        )


def resolve_ssl_resume(out_dir: str, ckpt_path: str, *, allow_fresh_start: bool = False,
                       tolerance: int = 5):
    """``(mode, start_epoch, blob)``:

    * ``"exact"``: ``ckpt_path`` is readable and current (its epoch plus
      ``tolerance`` reaches the log's); ``blob`` is its loaded tree.
    * ``"approx"``: the full state is missing or stale, the tracked
      ``disc_params.npz`` and ``gen_params.npz`` exist and the log shows
      more progress; ``blob`` is ``(disc_path, gen_path)`` and the epoch is
      the log's.
    * ``"fresh"``: nothing to resume (raises instead, through
      :func:`guard_fresh_start`, when the log shows progress and a fresh
      start was not allowed).
    """
    from .checkpoint import load_checkpoint

    prior = logged_progress(out_dir)
    exact_blob, exact_start = None, -1
    if os.path.exists(ckpt_path):
        try:
            exact_blob = load_checkpoint(ckpt_path)
            exact_start = int(exact_blob["epoch"]) + 1
        except (OSError, ValueError, KeyError, TypeError, EOFError, zipfile.BadZipFile) as e:  # truncated, corrupt
            print(f"WARNING: unreadable resume state {ckpt_path}: {e}")
            exact_blob = None

    disc_path = os.path.join(out_dir, "disc_params.npz")
    gen_path = os.path.join(out_dir, "gen_params.npz")
    params_ok = os.path.exists(disc_path) and os.path.exists(gen_path)

    if exact_blob is not None and exact_start + tolerance >= prior:
        return "exact", exact_start, exact_blob
    if params_ok and prior > max(exact_start, 0):
        if exact_blob is not None:
            print(f"WARNING: {ckpt_path} is STALE (epoch {exact_start} vs logged {prior}): resuming "
                  f"approximately from tracked params at epoch {prior} instead.")
        return "approx", prior, (disc_path, gen_path)
    if exact_blob is not None:  # the log is missing or behind, the state is fine
        return "exact", exact_start, exact_blob
    guard_fresh_start(out_dir, 0, allow_fresh_start=allow_fresh_start, unit="epoch")
    return "fresh", 0, None
