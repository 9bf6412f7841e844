"""Mixed-precision policy (counterpart of ``ctgan_tpu/core/precision.py``).

Parameters, Adam moments and loss reductions stay fp32; the operands of
convolutions and matrix products are cast to the active compute dtype
(``core.matmul``).  The compute dtype is the innermost
:func:`precision_policy` of this thread, else the process-wide default set by
:func:`default_policy` (fp32 until set).

The casts are explicit, at the JAX package's cast points, rather than
``torch.autocast``: autocast's op lists cast elsewhere (batch norm, bias
adds), and where bf16 rounds decides the numbers.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["compute_dtype", "default_policy", "precision_policy"]

_POLICY = threading.local()
_DEFAULT = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _stack() -> list:
    if not hasattr(_POLICY, "stack"):
        _POLICY.stack = []
    return _POLICY.stack


def _as_dtype(dtype) -> torch.dtype:
    dtype = _DTYPES.get(dtype, dtype)
    if dtype not in _DTYPES.values():
        raise ValueError(f"compute dtype must be float32 or bfloat16, not {dtype!r}")
    return dtype


def default_policy(enable_bf16: bool) -> None:
    """Set the process-wide default compute dtype: bf16 or fp32."""
    global _DEFAULT
    _DEFAULT = torch.bfloat16 if enable_bf16 else torch.float32


def compute_dtype() -> torch.dtype:
    s = _stack()
    return s[-1] if s else _DEFAULT


@contextlib.contextmanager
def precision_policy(dtype):
    """Compute in ``dtype`` ("float32", "bfloat16" or the torch dtype)
    inside the block, on this thread."""
    _stack().append(_as_dtype(dtype))
    try:
        yield
    finally:
        _stack().pop()
