"""Dropout keep-mask: the CUDA kernel ``csrc/dropout_mask.cu`` and its plain
PyTorch version.

Counterpart of ``ctgan_tpu/kernels/dropout.py`` (the Pallas kernel
``_mask_kernel``).  Both versions compute, for a 32-bit seed and a static
keep probability, a mask of the given shape whose element ``i`` is
``fp32(1/keep_prob)`` rounded to ``dtype`` where the Philox4x32-10 bits of
``i`` are below ``min(int(keep_prob * 2**32), 2**32 - 1)``, and 0 elsewhere.
The bits are those of the counter-based generator keyed on ``(seed, 0)`` with
counter ``(i // 4, 0, 0)``, word ``i % 4``: the kernel and
:func:`dropout_mask_reference` agree bit for bit.

:func:`dropout_mask` is the wrapper the model calls: on a CUDA device it
launches the kernel (and counts the launch in ``dropout_mask.launches``), on
the CPU it returns the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .build import load_library

__all__ = ["dropout_mask", "dropout_mask_reference", "philox4x32_10", "keep_threshold"]

_U32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``a * b`` for ``a, b < 2**32`` held in
    int64.  The full product overflows int64, so ``b`` is split into 16-bit
    halves: each partial product stays below 2**48."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _U32


def philox4x32_10(counter: torch.Tensor, seed: int) -> torch.Tensor:
    """Philox4x32-10 of the 64-bit ``counter`` values (int64, as counter
    words ``(lo, hi, 0, 0)``) under the key ``(seed, 0)``.  Returns int64
    ``[..., 4]`` holding the four uint32 output words."""
    c0, c1 = counter & _U32, counter >> 32
    c2 = torch.zeros_like(counter)
    c3 = torch.zeros_like(counter)
    k0, k1 = seed & _U32, 0
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + _PHILOX_W0) & _U32, (k1 + _PHILOX_W1) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def keep_threshold(keep_prob: float) -> int:
    """Keep iff bits < threshold (ctgan_tpu/kernels/dropout.py:53)."""
    return min(int(keep_prob * (1 << 32)), (1 << 32) - 1)


def _check(seed: int, keep_prob, dtype: torch.dtype) -> None:
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"dropout mask dtype must be float32 or bfloat16, not {dtype}")
    if not 0 <= seed <= _U32:
        raise ValueError(f"seed must be a uint32, got {seed}")
    if not isinstance(keep_prob, torch.Tensor) and not 0.0 < keep_prob <= 1.0:
        raise ValueError(f"keep_prob must lie in (0, 1], got {keep_prob}")


def dropout_mask_reference(
    seed: int, shape, keep_prob, dtype: torch.dtype = torch.float32, device="cpu"
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same Philox bits in int64
    tensor arithmetic.  ``keep_prob`` may also be a 0-d tensor (the plain
    dropout arm for a traced keep probability)."""
    _check(seed, keep_prob, dtype)
    n = math.prod(shape)
    groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    bits = philox4x32_10(groups, seed).reshape(-1)[:n].reshape(shape)
    if isinstance(keep_prob, torch.Tensor):
        kp = keep_prob.to(device=device, dtype=torch.float64)
        thresh = torch.clamp(torch.floor(kp * float(1 << 32)), max=float(_U32)).to(torch.int64)
        scale = (1.0 / kp).to(torch.float32)
    else:
        thresh = keep_threshold(keep_prob)
        scale = torch.tensor(np.float32(1.0 / keep_prob), device=device)
    return torch.where(bits < thresh, scale, torch.zeros((), device=device)).to(dtype)


@functools.cache
def _launcher():
    """The kernel's C entry point, built and loaded on first use."""
    fn = load_library("dropout_mask").ctgan_dropout_mask
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dropout_mask(
    seed: int, shape, keep_prob: float, dtype: torch.dtype = torch.float32, device="cuda"
) -> torch.Tensor:
    """Scaled keep-mask (0 or ``1/keep_prob``) of ``shape`` in ``dtype``.

    On a CUDA device this launches the kernel on the current stream; on the
    CPU it returns :func:`dropout_mask_reference`.  ``keep_prob`` is a static
    float (a tensor keep probability takes the plain arm in
    :func:`ctgan_tpu_torch.ops.dropout.dropout`)."""
    device = torch.device(device)
    _check(seed, keep_prob, dtype)
    if isinstance(keep_prob, torch.Tensor):
        raise TypeError("the kernel takes a static keep_prob; use dropout_mask_reference")
    if device.type == "cpu":
        return dropout_mask_reference(seed, shape, keep_prob, dtype, device)
    if device.type != "cuda":
        raise ValueError(f"dropout_mask runs on cuda or cpu, not {device}")
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.numel() == 0:
        return out
    if not out.is_contiguous() or out.data_ptr() % 16:
        raise RuntimeError("dropout_mask needs a contiguous, 16-byte aligned output")
    launch = _launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = launch(
            out.data_ptr(), out.numel(), seed, keep_threshold(keep_prob),
            float(np.float32(1.0 / keep_prob)), _DTYPE_CODES[dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"dropout_mask kernel launch failed with CUDA error {rc}")
    dropout_mask.launches += 1
    return out


dropout_mask.launches = 0
