"""Checkpoints, logging, resume safety, timing, tripwires, the step
watchdog, sample grids, experiment helpers and random search (counterpart
of ``ctgan_tpu/utils``; ``handwriting`` is imported by name)."""

from .checkpoint import device_get, latest_checkpoint, load_checkpoint, save_checkpoint
from .debug import assert_finite, check_grads_exist, print_stats, stats
from .experiments import (
    AttributeDict, BestParamSaver, filter_funcs_prefix, load_exp_params, load_log, prepare_dir, save_exp_params,
    short_format,
)
from .images import make_grid, save_images
from .logging import MetricLogger
from .profiler import StepTimer, profile_step
from .random_search import random_search
from .resume import guard_fresh_start, logged_progress, reap_stale_tmps, resolve_ssl_resume
from .watchdog import StepWatchdog

__all__ = [
    "AttributeDict", "BestParamSaver", "filter_funcs_prefix", "load_exp_params", "load_log", "prepare_dir",
    "random_search", "save_exp_params", "short_format",
    "MetricLogger", "StepTimer", "StepWatchdog", "assert_finite", "check_grads_exist", "device_get",
    "guard_fresh_start", "latest_checkpoint", "load_checkpoint", "logged_progress", "make_grid", "print_stats",
    "profile_step", "reap_stale_tmps", "resolve_ssl_resume", "save_checkpoint", "save_images", "stats",
]
