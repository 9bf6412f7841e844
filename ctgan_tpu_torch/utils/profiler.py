"""Step timing and tracing (counterpart of ``ctgan_tpu/utils/profiler.py``).

* :class:`StepTimer` gives the loop's ``time`` (seconds per iteration, host
  clock) and ``data time`` (seconds spent fetching the batch) metrics.
  Device work is asynchronous, so one iteration's ``time`` is the host's
  time to queue it plus any wait at a synchronising read; over a print
  window, whose flush synchronises, the mean is the true rate.
* :func:`profile_step` traces CPU and CUDA activity with ``torch.profiler``
  and writes a Chrome trace into ``log_dir``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["profile_step", "StepTimer"]


@contextlib.contextmanager
def profile_step(log_dir: str, enabled: bool = True):
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._data_time = 0.0

    @contextlib.contextmanager
    def data(self):
        t = time.perf_counter()
        yield
        self._data_time += time.perf_counter() - t

    def lap(self) -> tuple[float, float]:
        """(seconds since the last lap, data seconds among them)."""
        total = time.perf_counter() - self._t0
        data = self._data_time
        self.reset()
        return total, data
