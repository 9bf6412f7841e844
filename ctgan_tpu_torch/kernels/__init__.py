"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

``SOURCES`` names every kernel source under ``csrc/`` (built by
:func:`build.build_libraries`)."""

from .dropout import (
    dropout_mask,
    dropout_mask_reference,
    philox_uniform,
    philox_uniform_reference,
    seed_table,
)

SOURCES = ["dropout_mask"]

__all__ = [
    "SOURCES", "dropout_mask", "dropout_mask_reference", "philox_uniform",
    "philox_uniform_reference", "seed_table",
]
