"""Convolutions (counterpart of ``conv2d``, ``conv_mean_pool2d``,
``mean_pool_conv2d``, ``deconv2d``, ``upsample_conv2d``, ``conv1d`` and
``separable_conv2d`` in ``ctgan_tpu/ops/conv.py``).

NCHW activations and OIHW filters; ``ctgan_tpu_torch.bridge`` converts the
JAX package's HWIO filters.  Padding is TensorFlow's SAME, made explicit:
``F.conv2d(padding="same")`` refuses stride 2, and SAME at stride 2 can pad
one more row at the bottom than at the top.

The two fused forms rewrite a conv followed or preceded by a 2x2 mean pool
as one stride-2 conv with a transformed filter; ``upsample_conv2d``
rewrites a conv of the 2x nearest upsample as a conv on the small input.  The transform is plain
tensor math on the fp32 filter; the parameters are those of the unfused
conv, so both arms share checkpoints.

Every conv goes through ``core.matmul.conv`` (``conv_transpose``), which casts the input and the
(transformed) filter to the compute dtype of the precision policy; the bias
is added afterwards in the conv output's dtype, as the JAX package adds it
(``ctgan_tpu/ops/conv.py:118,193,247``).

``conv1d`` takes NCW activations and ``[out, in, W]`` filters (the JAX
package's NWC and ``[W, in, out]``, ``bridge``), with the reference's
autoregressive masks and weight norm; it runs as a 2-D conv of height 1.
``separable_conv2d`` is a depthwise conv (a grouped conv, one group per
input channel, ``depth_multiplier`` filters each) and a 1x1 conv.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.matmul import conv as _conv
from ..core.matmul import conv_transpose as _conv_transpose
from .pool import depth_to_space

__all__ = ["same_padding", "conv1d", "conv2d", "conv_mean_pool2d", "deconv2d", "mean_pool_conv2d",
           "separable_conv2d", "upsample_conv2d"]


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


def _same_conv(x: torch.Tensor, w: torch.Tensor, stride, groups: int = 1) -> torch.Tensor:
    """SAME conv of NCHW ``x``, no bias; ``stride`` an int or ``(sh, sw)``."""
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    ph = same_padding(x.shape[-2], w.shape[-2], sh)
    pw = same_padding(x.shape[-1], w.shape[-1], sw)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return _conv(x, w, stride=(sh, sw), padding=(ph[0], pw[0]), groups=groups)
    return _conv(F.pad(x, (*pw, *ph)), w, stride=(sh, sw), groups=groups)


def conv2d(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, stride: int = 1
) -> torch.Tensor:
    """2-D SAME conv."""
    return _add_bias(_same_conv(x, w, stride), b)


def _ar_mask_1d(filter_size: int, input_dim: int, output_dim: int, mask_type: str, n_channels: int) -> np.ndarray:
    """The autoregressive mask of a 1-D filter, ``[out, in, W]``
    (``ctgan_tpu/ops/conv.py:425-432``): the taps after the centre off, and
    at the centre channel ``i`` of ``n_channels`` to ``j`` where ``i >= j``
    (type "a") or ``i > j`` (type "b")."""
    mask = np.ones((filter_size, input_dim, output_dim), dtype="float32")
    center = filter_size // 2
    mask[center + 1:, :, :] = 0.0
    for i in range(n_channels):
        for j in range(n_channels):
            if (mask_type == "a" and i >= j) or (mask_type == "b" and i > j):
                mask[center, i::n_channels, j::n_channels] = 0.0
    return np.ascontiguousarray(mask.transpose(2, 1, 0))


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *, stride: int = 1,
           mask_type: tuple | None = None, g: torch.Tensor | None = None) -> torch.Tensor:
    """1-D SAME conv of NCW ``x`` with the ``[out, in, W]`` filter ``w``
    (``ctgan_tpu/ops/conv.py:385-445``).  ``g``: weight norm, each output
    filter scaled to norm ``g`` (no epsilon, as the JAX op); ``mask_type``:
    ``("a" | "b", n_channels)``, applied after the weight norm.  The JAX
    op's ``gain`` and ``he_init`` only shape its initialisation."""
    if g is not None:
        w = w * (g / torch.sqrt(w.square().sum(dim=(1, 2)))).reshape(-1, 1, 1)
    if mask_type is not None:
        mask = _ar_mask_1d(w.shape[-1], w.shape[1], w.shape[0], *mask_type)
        w = w * torch.from_numpy(mask).to(w.device, w.dtype)
    out = _same_conv(x.unsqueeze(2), w.unsqueeze(2), (1, stride)).squeeze(2)
    return out if b is None else out + b.to(out.dtype)[:, None]


def separable_conv2d(x: torch.Tensor, depthwise: torch.Tensor, pointwise: torch.Tensor,
                     b: torch.Tensor | None = None, *, stride: int = 1) -> torch.Tensor:
    """Depthwise-separable SAME conv (``ctgan_tpu/ops/conv.py:448-496``):
    ``depthwise`` ``[in, mult, kh, kw]`` (``bridge``), run as the grouped
    filter ``[in * mult, 1, kh, kw]``, one group per input channel, at
    ``stride``; then the 1x1 ``pointwise`` ``[out, in * mult, 1, 1]``."""
    cin, mult, kh, kw = depthwise.shape
    out = _same_conv(x, depthwise.reshape(cin * mult, 1, kh, kw), stride, groups=cin)
    return _add_bias(_same_conv(out, pointwise, 1), b)


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
    pads ``2H`` asymmetrically, (1, 2) for a 5x5 filter at stride 2 and
    (0, 1) for a 3x3, so the transposed conv crops that leading pad from its
    full ``2H - 2 + k`` output (``padding=lead``) and then keeps the first
    ``2H`` rows and columns.  ``output_padding`` cannot express it: for 5x5,
    ``padding=2, output_padding=1`` has the right shape and is shifted by one
    pixel.  The JAX models use odd square filters (5x5 in the DCGAN family,
    3x3 in the bottleneck blocks) at stride 2 only, and nothing else is
    accepted."""
    k = w.shape[-1]
    if k % 2 != 1 or w.shape[-2] != k or stride != 2:
        raise ValueError(f"deconv2d takes the JAX models' odd square filters at stride 2 (got {w.shape[-2]}x{k}, "
                         f"stride {stride})")
    h, wd = x.shape[-2:]
    lead = (same_padding(stride * h, k, stride)[0], same_padding(stride * wd, k, stride)[0])
    out = _conv_transpose(x, w, stride=stride, padding=lead)
    return _add_bias(out[:, :, : stride * h, : stride * wd], b)


def _upsample_collapse_map(filter_size: int) -> tuple[np.ndarray, int]:
    """The constant ``M[u, v, a, b, r, c]`` in {0, 1} that rewrites a SAME
    conv of the 2x nearest upsample as a conv of the small input
    (``ctgan_tpu/ops/conv.py:30-53``): the upsampled pixel ``p`` reads the
    small pixel ``p // 2``, so the tap ``u`` of the output row ``2i + a``
    reads the small row ``i + (a + u - pad) // 2``.  ``M`` sends the tap
    ``(u, v)`` to position ``(r, c)`` of the parity-``(a, b)`` filter.  Exact
    for an odd filter, borders included."""
    pad = (filter_size - 1) // 2
    offs = {a: [(a + u - pad) // 2 for u in range(filter_size)] for a in (0, 1)}
    maxoff = max(abs(o) for a in (0, 1) for o in offs[a])
    ks = 2 * maxoff + 1
    m = np.zeros((filter_size, filter_size, 2, 2, ks, ks), dtype="float32")
    for a in (0, 1):
        for b in (0, 1):
            for u in range(filter_size):
                for v in range(filter_size):
                    m[u, v, a, b, offs[a][u] + maxoff, offs[b][v] + maxoff] = 1.0
    return m, ks


def upsample_conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``conv2d(upsample_nearest(x), w, b)`` without the 4x intermediate
    (``ctgan_tpu/ops/conv.py:56-120``): one SAME conv of the small input
    with the four parity filters stacked on the output channels, ``(a * 2 +
    b) * C + o``, then ``depth_to_space``.  The same parameters as the plain
    path; off in the models, as in the JAX package (``FUSE_UPSAMPLE_CONV =
    False``)."""
    k = _require_odd("upsample_conv2d", w)
    m, ks = _upsample_collapse_map(k)
    cout, cin = w.shape[:2]
    w4 = torch.einsum("oiuv,uvabrc->aboirc", w, torch.from_numpy(m).to(w.device, w.dtype))
    out = depth_to_space(conv2d(x, w4.reshape(4 * cout, cin, ks, ks)), 2)
    return _add_bias(out, b)
