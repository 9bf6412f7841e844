"""Dropout keep-mask and Philox uniforms: the CUDA kernels of
``csrc/dropout_mask.cu`` and their plain PyTorch versions.

Counterpart of ``ctgan_tpu/kernels/dropout.py`` (the Pallas kernel
``_mask_kernel``).  Both versions compute, for a 32-bit seed and a static
keep probability, a mask of the given shape whose element ``i`` is
``fp32(1/keep_prob)`` rounded to ``dtype`` where the Philox4x32-10 bits of
``i`` are below ``min(int(keep_prob * 2**32), 2**32 - 1)``, and 0 elsewhere.
The bits are those of the counter-based generator keyed on ``(seed, 0)`` with
counter ``(i // 4, 0, 0)``, word ``i % 4``: the kernel and
:func:`dropout_mask_reference` agree bit for bit.

The seed is an int, or a *seed table*: a 1-D ``torch.int32`` tensor on the
output's device holding uint32 bit patterns (:func:`seed_table`), read at
``slot``.  The kernels read ``seeds[slot]`` from device memory, so a CUDA
graph that captured a launch draws anew when the table is overwritten; an
int seed is a one-element table.  The plain versions take ``seeds[slot]``
as a 0-d tensor on the table's device, never reading it on the host, so a
graph that captured them draws anew too.

:func:`dropout_mask` is the wrapper the model calls: on a CUDA device it
launches the kernel (and counts the launch in ``dropout_mask.launches``), on
the CPU it returns the plain version.

:func:`philox_uniform` turns the same bits into fp32 uniforms in [0,
``scale``): element ``i`` is ``(bits_i >> 8) * 2**-24 * scale``, exact up to
the one multiply by ``scale``.  The trainer's dequantisation noise comes from
it, so a run draws the same noise on the card as on the CPU
(:func:`philox_uniform_reference`); it counts its launches in
``philox_uniform.launches``.

Row segments.  Each function also takes ``segments``: at most
``MAX_SEGMENTS`` ``(start, count)`` element ranges of a global draw, whose
counts add up to the output's size.  The output holds them one after
another, element ``j`` of a segment taking exactly the bits of element
``start + j`` of the global draw: a process of a data-parallel run draws its
rows of the one-process draw.  ``None``, or the one segment ``(0, n)``, is
the whole draw and launches the one-segment kernel; any other layout
launches the segment kernel, which each wrapper counts in
``segment_launches`` as well as in ``launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .build import load_library

__all__ = [
    "MAX_SEGMENTS", "dropout_mask", "dropout_mask_reference", "keep_threshold", "philox4x32_10",
    "philox_uniform", "philox_uniform_reference", "seed_table", "whole",
]

_U32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ELEMENTS = 1 << 34  # the kernels count chunks and Philox counters in 32 bits
MAX_SEGMENTS = 4  # row segments one launch takes (the fused CT pass: real, fake, real, fake)


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``a * b`` for ``a, b < 2**32`` held in
    int64.  The full product overflows int64, so ``b`` is split into 16-bit
    halves: each partial product stays below 2**48."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _U32


def philox4x32_10(counter: torch.Tensor, seed: int | torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 of the 64-bit ``counter`` values (int64, as counter
    words ``(lo, hi, 0, 0)``) under the key ``(seed, 0)``; ``seed`` is an
    int or a 0-d int64 tensor on ``counter``'s device.  Returns int64
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


def seed_table(seeds, device="cpu") -> torch.Tensor:
    """A seed table on ``device``: the uint32 ``seeds`` as the bit patterns
    of a 1-D ``torch.int32`` tensor."""
    values = np.asarray(seeds, dtype=np.int64).reshape(-1)
    if values.size and (values.min() < 0 or values.max() > _U32):
        raise ValueError(f"seeds must be uint32, got {values}")
    return torch.from_numpy(values.astype(np.uint32).view(np.int32)).to(device)


def _check_seed(seed: int) -> None:
    if not 0 <= seed <= _U32:
        raise ValueError(f"seed must be a uint32, got {seed}")


def _check_table(seeds: torch.Tensor, slot: int, device: torch.device) -> None:
    """A table the kernel can read at ``slot`` for an output on ``device``."""
    if seeds.dtype != torch.int32 or seeds.dim() != 1 or not seeds.is_contiguous():
        raise TypeError(f"a seed table is a contiguous 1-D int32 tensor, not {seeds.dtype} {tuple(seeds.shape)}")
    if seeds.device != device:
        raise ValueError(f"the seed table lies on {seeds.device}, the output on {device}")
    if not 0 <= slot < seeds.numel():
        raise IndexError(f"slot {slot} outside a seed table of {seeds.numel()}")


def _seed_value(seed, slot: int) -> int | torch.Tensor:
    """The uint32 seed an int gives, or ``seeds[slot]`` as a 0-d int64
    tensor on the table's device (no host read)."""
    if isinstance(seed, torch.Tensor):
        _check_table(seed, slot, seed.device)
        return seed[slot].to(torch.int64) & _U32
    _check_seed(seed)
    return seed


def _check(keep_prob, dtype: torch.dtype) -> None:
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"dropout mask dtype must be float32 or bfloat16, not {dtype}")
    if not isinstance(keep_prob, torch.Tensor) and not 0.0 < keep_prob <= 1.0:
        raise ValueError(f"keep_prob must lie in (0, 1], got {keep_prob}")


def whole(segments, n: int) -> bool:
    """Whether ``segments`` is the whole draw of ``n`` elements."""
    return segments is None or [tuple(s) for s in segments] == [(0, n)]


def _check_segments(segments, n: int) -> list[tuple[int, int]]:
    segs = [(int(a), int(c)) for a, c in segments]
    if not 1 <= len(segs) <= MAX_SEGMENTS:
        raise ValueError(f"1 to {MAX_SEGMENTS} segments, not {len(segs)}")
    if any(a < 0 or c <= 0 or a + c >= _MAX_ELEMENTS for a, c in segs):
        raise ValueError(f"segments {segs}: starts >= 0, counts > 0, ends below 2**34")
    if sum(c for _, c in segs) != n:
        raise ValueError(f"segments {segs} hold {sum(c for _, c in segs)} elements, the output {n}")
    return segs


def _bits(seed: int | torch.Tensor, n: int, device, segments=None) -> torch.Tensor:
    """The first ``n`` Philox words of ``seed`` (int64 holding uint32), or
    the words of ``segments``' global elements, one segment after
    another."""
    if whole(segments, n):
        groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
        return philox4x32_10(groups, seed).reshape(-1)[:n]
    parts = []
    for start, count in _check_segments(segments, n):
        groups = torch.arange(start // 4, (start + count + 3) // 4, dtype=torch.int64, device=device)
        words = philox4x32_10(groups, seed).reshape(-1)
        parts.append(words[start % 4:start % 4 + count])
    return torch.cat(parts)


def dropout_mask_reference(
    seed, shape, keep_prob, dtype: torch.dtype = torch.float32, device="cpu", *, slot: int = 0, segments=None
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same Philox bits in int64
    tensor arithmetic.  ``seed`` is an int or a seed table read at
    ``slot``.  ``keep_prob`` may also be a 0-d tensor (the plain dropout arm
    for a traced keep probability).  ``segments``: the global elements to
    draw (the module's docstring)."""
    _check(keep_prob, dtype)
    bits = _bits(_seed_value(seed, slot), math.prod(shape), device, segments).reshape(shape)
    if isinstance(keep_prob, torch.Tensor):
        kp = keep_prob.to(device=device, dtype=torch.float64)
        thresh = torch.clamp(torch.floor(kp * float(1 << 32)), max=float(_U32)).to(torch.int64)
        scale = (1.0 / kp).to(torch.float32)
    else:
        thresh = keep_threshold(keep_prob)
        scale = torch.full((), float(np.float32(1.0 / keep_prob)), dtype=torch.float32, device=device)
    return torch.where(bits < thresh, scale, torch.zeros((), device=device)).to(dtype)


def philox_uniform_reference(seed, shape, scale: float = 1.0, device="cpu", *, slot: int = 0,
                             segments=None) -> torch.Tensor:
    """Plain PyTorch version of the uniform kernel: fp32 values in [0,
    ``scale``) from the same Philox bits; ``seed`` and ``segments`` as in
    :func:`dropout_mask_reference`."""
    u = (_bits(_seed_value(seed, slot), math.prod(shape), device, segments) >> 8).to(torch.float32) * 2.0**-24
    return (u * torch.full((), float(np.float32(scale)), dtype=torch.float32, device=device)).reshape(shape)


_I64P = ctypes.POINTER(ctypes.c_int64)


@functools.cache
def _entry(name: str):
    """A C entry point of the library, built and loaded on first use."""
    fn = getattr(load_library("dropout_mask"), name)
    fn.argtypes = {
        "ctgan_dropout_mask": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_uint32, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        "ctgan_philox_uniform": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_void_p],
        "ctgan_dropout_mask_segments": [ctypes.c_void_p, _I64P, _I64P, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_uint32, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        "ctgan_philox_uniform_segments": [ctypes.c_void_p, _I64P, _I64P, ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, out: torch.Tensor, seed, slot: int, *args, segments=None) -> None:
    """Launch ``name`` on ``out``'s device and current stream with the seed
    ``seed`` (an int: a one-element table) or ``seeds[slot]``; with
    ``segments`` its ``_segments`` entry.  Raises if the launch fails."""
    if not out.is_contiguous() or out.data_ptr() % 16:
        raise RuntimeError(f"{name} needs a contiguous, 16-byte aligned output")
    if out.numel() >= _MAX_ELEMENTS:
        raise ValueError(f"{name} takes fewer than 2**34 elements, not {out.numel()}")
    if not isinstance(seed, torch.Tensor):
        seed, slot = seed_table([seed], out.device), 0
    _check_table(seed, slot, out.device)
    if segments is None:
        head = (out.numel(),)
    else:
        segs = _check_segments(segments, out.numel())
        starts = (ctypes.c_int64 * len(segs))(*(a for a, _ in segs))
        counts = (ctypes.c_int64 * len(segs))(*(c for _, c in segs))
        name, head = name + "_segments", (starts, counts, len(segs))
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = _entry(name)(out.data_ptr(), *head, seed.data_ptr(), slot, *args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def _output_device(seed, slot: int, device) -> torch.device:
    """``device``, checked against what the kernels run on, with the seed:
    an int in range, or a table on the CPU for a CPU output (a table for a
    CUDA output is checked against the output at the launch)."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cuda or cpu, not {device}")
    if not isinstance(seed, torch.Tensor):
        _check_seed(seed)
    elif device.type == "cpu":
        _check_table(seed, slot, device)
    return device


def dropout_mask(
    seed, shape, keep_prob: float, dtype: torch.dtype = torch.float32, device="cuda", *, slot: int = 0,
    segments=None,
) -> torch.Tensor:
    """Scaled keep-mask (0 or ``1/keep_prob``) of ``shape`` in ``dtype``,
    from the uint32 ``seed`` or the seed table ``seed`` at ``slot``.

    On a CUDA device this launches the kernel on the current stream; on the
    CPU it returns :func:`dropout_mask_reference`.  ``keep_prob`` is a static
    float (a tensor keep probability takes the plain arm in
    :func:`ctgan_tpu_torch.ops.dropout.dropout`).  ``segments``: the global
    elements to draw (the module's docstring)."""
    device = _output_device(seed, slot, device)
    _check(keep_prob, dtype)
    if isinstance(keep_prob, torch.Tensor):
        raise TypeError("the kernel takes a static keep_prob; use dropout_mask_reference")
    if device.type == "cpu":
        return dropout_mask_reference(seed, shape, keep_prob, dtype, device, slot=slot, segments=segments)
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.numel() == 0:
        return out
    segments = None if whole(segments, out.numel()) else segments
    _launch("ctgan_dropout_mask", out, seed, slot, keep_threshold(keep_prob),
            float(np.float32(1.0 / keep_prob)), _DTYPE_CODES[dtype], segments=segments)
    dropout_mask.launches += 1
    dropout_mask.segment_launches += segments is not None
    return out


dropout_mask.launches = 0
dropout_mask.segment_launches = 0


def philox_uniform(seed, shape, scale: float = 1.0, device="cuda", *, slot: int = 0,
                   segments=None) -> torch.Tensor:
    """fp32 uniforms in [0, ``scale``) of ``shape``, a function of the
    uint32 ``seed`` or of the seed table ``seed`` at ``slot``; ``segments``
    as in :func:`dropout_mask`.

    On a CUDA device this launches the kernel on the current stream; on the
    CPU it returns :func:`philox_uniform_reference`."""
    device = _output_device(seed, slot, device)
    if device.type == "cpu":
        return philox_uniform_reference(seed, shape, scale, device, slot=slot, segments=segments)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    segments = None if whole(segments, out.numel()) else segments
    _launch("ctgan_philox_uniform", out, seed, slot, float(np.float32(scale)), segments=segments)
    philox_uniform.launches += 1
    philox_uniform.segment_launches += segments is not None
    return out


philox_uniform.launches = 0
philox_uniform.segment_launches = 0
