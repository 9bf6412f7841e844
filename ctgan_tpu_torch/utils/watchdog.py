"""Hang detection for training runs (own copy of
``ctgan_tpu/utils/watchdog.py``: threads and ``faulthandler`` only).

A wedged device call raises nothing, so the only recovery is process
death: the runner sees a nonzero exit, retries, and the loop resumes from
its last checkpoint.  :class:`StepWatchdog` runs a daemon thread that
checks a beat; the training loop calls ``beat()`` once per iteration.  If
no beat lands for ``deadline`` seconds the thread dumps every Python
thread's stack to stderr and exits the process with ``EXIT_CODE``.

Deadlines have two phases: ``$CTGAN_STEP_TIMEOUT`` (default 900 s) bounds
the gap between beats, ``$CTGAN_STEP_TIMEOUT_FIRST`` (default
max(steady, 1800 s)) the time from start to the first beat, which covers
kernel builds and warm-up.  ``CTGAN_STEP_TIMEOUT=0`` disables it.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time

__all__ = ["StepWatchdog", "EXIT_CODE"]

EXIT_CODE = 3  # distinct from timeout(1)'s 124: queue runners retry on it


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class StepWatchdog:
    """Abort the process if the training loop stops beating.

    Usage::

        wd = StepWatchdog.start_from_env(name="good64")
        try:
            for ...:
                step(...)
                wd.beat()
        finally:
            wd.stop()

    ``start_from_env`` returns a no-op watchdog when disabled, so call
    sites never branch.
    """

    def __init__(self, deadline: float, name: str = "train",
                 poll: float | None = None, _exit=os._exit,
                 first_deadline: float | None = None):
        self.deadline = float(deadline)
        # pre-first-beat window (covers a cold compile); defaults to the
        # steady deadline so direct constructions behave single-phase
        self.first_deadline = (
            float(first_deadline) if first_deadline is not None
            else self.deadline
        )
        self.name = name
        self._exit = _exit
        self._poll = poll if poll is not None else min(30.0, self.deadline / 4)
        self._last = time.monotonic()
        self._beaten = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------
    @classmethod
    def start_from_env(cls, name: str = "train") -> "StepWatchdog":
        deadline = _env_float("CTGAN_STEP_TIMEOUT", 900.0)
        first = _env_float("CTGAN_STEP_TIMEOUT_FIRST", max(deadline, 1800.0))
        wd = cls(deadline, name=name, first_deadline=first)
        if deadline > 0:
            wd.start()
        return wd

    def start(self) -> None:
        self._last = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name=f"step-watchdog-{self.name}", daemon=True
        )
        self._thread.start()

    def beat(self) -> None:
        self._last = time.monotonic()
        self._beaten = True

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- internals -----------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            limit = self.deadline if self._beaten else self.first_deadline
            quiet = time.monotonic() - self._last
            if quiet >= limit:
                self._fire(quiet, limit)
                return

    def _fire(self, quiet: float, limit: float | None = None) -> None:
        sys.stderr.write(
            f"StepWatchdog[{self.name}]: no step progress for {quiet:.0f}s "
            f"(deadline {self.deadline if limit is None else limit:.0f}s) "
            f"— assuming a wedged device "
            f"call; dumping thread stacks and exiting {EXIT_CODE} so the "
            f"runner retries from the last checkpoint.\n"
        )
        try:
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        except (OSError, ValueError, RuntimeError):
            pass  # no usable stderr: exit all the same
        sys.stderr.flush()
        sys.stdout.flush()
        self._exit(EXIT_CODE)
