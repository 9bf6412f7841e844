"""Resume safety (own copy of ``ctgan_tpu/utils/resume.py:43-116``).

* :func:`guard_fresh_start` refuses to train from iteration S in a
  directory whose ``log.pkl`` records progress beyond S (plus a tolerance,
  the save cadence), unless ``allow_fresh_start`` or
  ``$CTGAN_ALLOW_FRESH_START=1``: the full checkpoints are gone or stale,
  and starting over would overwrite the logged work.
* :func:`reap_stale_tmps` deletes the temporary files that an atomic
  checkpoint write leaves when its process is killed.
* :func:`logged_progress` is the highest iteration in ``log.pkl``.

The approximate resume from ``params_latest.npz`` lives in
``train.loop.train_loop``.  ``resolve_ssl_resume`` comes with the
semi-supervised apps.
"""

from __future__ import annotations

import glob
import os
import pickle

__all__ = ["logged_progress", "reap_stale_tmps", "guard_fresh_start"]


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
