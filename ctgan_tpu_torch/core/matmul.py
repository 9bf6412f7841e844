"""Matrix product and convolution under the precision policy (counterpart
of ``matmul``, ``conv`` and ``conv_transpose`` in
``ctgan_tpu/core/matmul.py``).

Under fp32 both operands are promoted to their common type, at least fp32
(an activation that is bf16 is promoted, as ``jnp.dot`` promotes it; a
float64 run stays float64), and so is the result.  Under bf16 both
operands are cast to bf16; the card accumulates in fp32 and rounds the
result to bf16 once, and the result stays bf16 (the default,
``keep_bf16_activations(True)``); under ``keep_bf16_activations(False)``
that bf16 result is cast to fp32.  Biases are added by the callers, in the
result's dtype.

fp32 here means what PyTorch runs by default on the card: cuDNN computes
fp32 convolutions in TF32, and matrix products stay in full fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import compute_dtype

__all__ = ["conv", "conv_transpose", "keep_bf16_activations", "matmul"]

_KEEP_BF16_ACT = [True]


def keep_bf16_activations(enable: bool) -> None:
    """Whether a bf16 product or convolution returns bf16 (True, the
    default) or its bf16-rounded value as fp32 (False), as the JAX
    package's switch (``ctgan_tpu/core/matmul.py:35-41``, ``_out_dtype``).
    Process-wide; read when an op runs, so a step captured in a CUDA graph
    keeps the setting it was captured under."""
    _KEEP_BF16_ACT[0] = bool(enable)


def _fp32_operands(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    return torch.promote_types(torch.promote_types(a.dtype, b.dtype), torch.float32)


def _apply(op, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    dt = compute_dtype()
    if dt == torch.float32:
        dt = _fp32_operands(x, w)
        return op(x.to(dt), w.to(dt))
    if x.device.type == "cpu":
        # bf16 operands, fp32 accumulation, one rounding of the result: what
        # the card does.  PyTorch's CPU bf16 convolution accumulates its
        # double backward in bf16 and loses it (tests/test_torch_bf16.py).
        out = op(x.to(dt).float(), w.to(dt).float()).to(dt)
    else:
        out = op(x.to(dt), w.to(dt))
    return out if _KEEP_BF16_ACT[0] else out.float()


def matmul(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T`` over the last axis; ``weight`` is ``[out, in]``."""
    return _apply(F.linear, x, weight)


def conv(x: torch.Tensor, filters: torch.Tensor, *, stride: int = 1, padding=0, groups: int = 1) -> torch.Tensor:
    """2-D convolution of NCHW ``x`` with OIHW ``filters``, no bias
    (``groups``: a grouped conv's, ``filters`` ``[O, I / groups, H, W]``)."""
    return _apply(lambda a, b: F.conv2d(a, b, stride=stride, padding=padding, groups=groups), x, filters)


def conv_transpose(x: torch.Tensor, filters: torch.Tensor, *, stride: int, padding: int) -> torch.Tensor:
    """2-D transposed convolution of NCHW ``x`` with ``[in, out, kH, kW]``
    ``filters``, no bias."""
    return _apply(lambda a, b: F.conv_transpose2d(a, b, stride=stride, padding=padding), x, filters)
