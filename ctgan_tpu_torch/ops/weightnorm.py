"""Weight-normalised layers with data-dependent init (counterpart of
``wn_dense``, ``wn_conv2d``, ``wn_deconv2d`` and ``l2_dense`` in
``ctgan_tpu/ops/weightnorm.py:42-200``).

The applied weight is ``g * W / ||W||`` per output unit, the norm being
``sqrt(1e-6 + sum(W^2))`` over every axis but the output's
(:func:`applied_weight`); the bias is added after the product and the
nonlinearity last.  Layouts are the port's (``bridge``): a dense ``W`` is
``[out, in]``, a conv's ``[out, in, k, k]``, a transposed conv's ``[in, out,
k, k]`` (the JAX package's ``(k, k, out, in)``, norms over its axes ``(0,
1, 3)``).

The layers take the applied weight, not ``W``: a caller that runs several
passes over the same parameters normalises once and the passes share it
(autograd sums their gradients before it differentiates the normalisation
once), as the JAX step's one compiled program computes it once.

Data-dependent init (Salimans and Kingma): given ``on_init``, the layer
standardises its pre-activations over the batch (and the spatial axes) to
zero mean and ``init_stdv`` standard deviation inside the pass, so the layers
after it see initialised statistics, and hands the new ``(g, b)`` to
``on_init(g, b)``; ``b`` is then not added.  ``g``, the layer's gain, is
read only there.  ``train/wn_init.py`` collects them.  Nothing is kept
between calls.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.matmul import conv as _conv
from ..core.matmul import matmul
from .conv import conv2d, deconv2d

__all__ = ["applied_weight", "l2_dense", "wn_conv2d", "wn_deconv2d", "wn_dense"]

EPS = 1e-6
OnInit = Callable[[torch.Tensor, torch.Tensor], None]


def _norms(w: torch.Tensor, dims) -> torch.Tensor:
    return torch.sqrt(EPS + w.square().sum(dim=dims))


def applied_weight(w: torch.Tensor, g: torch.Tensor, out_dim: int = 0) -> torch.Tensor:
    """``g * W / ||W||``, the norm over every axis but ``out_dim`` (0 for a
    dense or conv ``W``, 1 for a transposed conv's)."""
    dims = tuple(d for d in range(w.ndim) if d != out_dim)
    shape = [1] * w.ndim
    shape[out_dim] = -1
    return w * (g / _norms(w, dims)).reshape(shape)


def _finish(pre: torch.Tensor, g, b, nonlinearity, init_stdv: float, on_init: OnInit | None,
            dims) -> torch.Tensor:
    """Bias (or, with ``on_init``, the data-dependent init over ``dims``:
    ``g`` is then the layer's gain), then the nonlinearity.  ``b``
    broadcasts against ``pre``."""
    if on_init is not None:
        m = pre.mean(dim=dims, keepdim=True)
        inv_stdv = init_stdv / torch.sqrt((pre - m).square().mean(dim=dims, keepdim=True))
        on_init(g * inv_stdv.reshape(-1), (-m * inv_stdv).reshape(-1))
        pre = (pre - m) * inv_stdv
    else:
        pre = pre + b.to(pre.dtype)
    return nonlinearity(pre) if nonlinearity is not None else pre


def wn_dense(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, b: torch.Tensor, *,
             nonlinearity=torch.relu, init_stdv: float = 1.0, on_init: OnInit | None = None) -> torch.Tensor:
    """``[N, in]`` -> ``[N, out]``; ``w`` the applied ``[out, in]`` weight."""
    return _finish(matmul(x, w), g, b, nonlinearity, init_stdv, on_init, (0,))


def _per_channel(t: torch.Tensor) -> torch.Tensor:
    return t[:, None, None]


def wn_conv2d(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, b: torch.Tensor, *, stride: int = 1,
              pad: str | int = "SAME", nonlinearity=torch.relu, init_stdv: float = 1.0,
              on_init: OnInit | None = None) -> torch.Tensor:
    """NCHW conv with the applied filter ``w``; ``pad`` is ``"SAME"``
    (TF's), ``"VALID"`` or a symmetric integer pad (the CIFAR classifier's
    3x3 convs take 1)."""
    if pad == "SAME":
        pre = conv2d(x, w, None, stride=stride)
    else:
        pre = _conv(x, w, stride=stride, padding=0 if pad == "VALID" else int(pad))
    return _finish(pre, g, _per_channel(b), nonlinearity, init_stdv, on_init, (0, 2, 3))


def wn_deconv2d(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, b: torch.Tensor, *,
                nonlinearity=torch.relu, init_stdv: float = 1.0, on_init: OnInit | None = None) -> torch.Tensor:
    """TF's SAME 5x5 stride-2 transposed conv (``ops.conv.deconv2d``) with
    the applied filter ``w`` (``applied_weight(W, g, 1)``), ``H x W`` ->
    ``2H x 2W``."""
    return _finish(deconv2d(x, w, None), g, _per_channel(b), nonlinearity, init_stdv, on_init,
                   (0, 2, 3))


def l2_dense(x: torch.Tensor, w: torch.Tensor, *, nonlinearity=None) -> torch.Tensor:
    """Dense layer with L2-normalised weights, no learned scale, no bias."""
    pre = matmul(x, w / torch.sqrt(EPS + w.square().sum(dim=1, keepdim=True)))
    return nonlinearity(pre) if nonlinearity is not None else pre
