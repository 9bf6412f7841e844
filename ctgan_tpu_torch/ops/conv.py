"""Convolutions (counterpart of ``conv2d``, ``conv_mean_pool2d``,
``mean_pool_conv2d`` and ``deconv2d`` in ``ctgan_tpu/ops/conv.py``).

NCHW activations and OIHW filters; ``ctgan_tpu_torch.bridge`` converts the
JAX package's HWIO filters.  Padding is TensorFlow's SAME, made explicit:
``F.conv2d(padding="same")`` refuses stride 2, and SAME at stride 2 can pad
one more row at the bottom than at the top.

The two fused forms rewrite a conv followed or preceded by a 2x2 mean pool
as one stride-2 conv with a transformed filter.  The transform is plain
tensor math on the fp32 filter; the parameters are those of the unfused
conv, so both arms share checkpoints.

Every conv goes through ``core.matmul.conv`` (``conv_transpose``), which casts the input and the
(transformed) filter to the compute dtype of the precision policy; the bias
is added afterwards in the conv output's dtype, as the JAX package adds it
(``ctgan_tpu/ops/conv.py:118,193,247``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.matmul import conv as _conv
from ..core.matmul import conv_transpose as _conv_transpose

__all__ = ["same_padding", "conv2d", "conv_mean_pool2d", "deconv2d", "mean_pool_conv2d"]


def same_padding(size: int, filter_size: int, stride: int) -> tuple[int, int]:
    """TF SAME padding (before, after) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + filter_size - size, 0)
    return total // 2, total - total // 2


def _require_odd(fn_name: str, w: torch.Tensor) -> int:
    k = w.shape[-1]
    if k % 2 != 1:
        raise ValueError(f"{fn_name} requires an odd filter_size (got {k})")
    return k


def _require_even_hw(fn_name: str, x: torch.Tensor) -> None:
    h, w = x.shape[-2:]
    if h % 2 or w % 2:
        raise ValueError(
            f"{fn_name} requires even spatial dims (got {h}x{w}): the fused "
            "stride-2 rewrite assumes non-overlapping 2x2 pool windows"
        )


def _add_bias(out: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    return out if b is None else out + b.to(out.dtype)[:, None, None]


def conv2d(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, stride: int = 1
) -> torch.Tensor:
    """2-D SAME conv."""
    ph = same_padding(x.shape[-2], w.shape[-2], stride)
    pw = same_padding(x.shape[-1], w.shape[-1], stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return _add_bias(_conv(x, w, stride=stride, padding=(ph[0], pw[0])), b)
    return _add_bias(_conv(F.pad(x, (*pw, *ph)), w, stride=stride), b)


def conv_mean_pool2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``mean_pool(conv2d(x, w, b))`` as one stride-2 conv.

    The (K+1)x(K+1) filter is the K x K filter convolved with the 2x2 box
    over 4, with (K-1)//2 padding per side: exact, boundaries included, for
    odd K and even H, W (ctgan_tpu/ops/conv.py:131-194)."""
    k = _require_odd("conv_mean_pool2d", w)
    _require_even_hw("conv_mean_pool2d", x)
    wf = 0.25 * sum(F.pad(w, (c, 1 - c, r, 1 - r)) for r in (0, 1) for c in (0, 1))
    return _add_bias(_conv(x, wf, stride=2, padding=(k - 1) // 2), b)


def mean_pool_conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``conv2d(mean_pool(x), w, b)`` as one stride-2 conv.

    The 2K x 2K filter repeats each tap over its 2x2 pool window, over 4,
    with K-1 padding per side (ctgan_tpu/ops/conv.py:197-248)."""
    k = _require_odd("mean_pool_conv2d", w)
    _require_even_hw("mean_pool_conv2d", x)
    wf = 0.25 * w.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return _add_bias(_conv(x, wf, stride=2, padding=k - 1), b)


def deconv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, stride: int = 2) -> torch.Tensor:
    """TF's SAME transposed conv (``tf.nn.conv2d_transpose``): the gradient
    of the SAME stride-2 conv that maps ``2H x 2W`` to ``H x W``, so the
    output is exactly ``2H x 2W`` (``ctgan_tpu/ops/conv.py:335-382``).

    ``w`` is ``[in, out, kH, kW]``: the bridge turns the JAX package's HWOI
    filter into what it calls OIHW by ``permute(3, 2, 0, 1)``, which for a
    transposed conv is ``[in, out, kH, kW]``, the layout
    ``F.conv_transpose2d`` takes, with no spatial flip.  That forward conv
    pads ``2H`` asymmetrically, (1, 2) for a 5x5 filter at stride 2, so the
    transposed conv crops that leading pad from its full ``2H + 3`` output
    (``padding=1``) and then keeps the first ``2H`` rows and columns.
    ``output_padding`` cannot express it: ``padding=2, output_padding=1``
    has the right shape and is shifted by one pixel.  The JAX models use 5x5
    filters at stride 2 only, and nothing else is accepted."""
    k = w.shape[-1]
    if k != 5 or w.shape[-2] != 5 or stride != 2:
        raise ValueError(f"deconv2d takes the JAX models' 5x5 filters at stride 2 (got {k}x{w.shape[-2]}, "
                         f"stride {stride})")
    h, wd = x.shape[-2:]
    lead = (same_padding(stride * h, k, stride)[0], same_padding(stride * wd, k, stride)[0])
    out = _conv_transpose(x, w, stride=stride, padding=lead)
    return _add_bias(out[:, :, : stride * h, : stride * wd], b)
