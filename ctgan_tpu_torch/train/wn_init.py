"""Data-dependent weight-norm init (counterpart of
``ctgan_tpu/train/wn_init.py:25-41``).

The reference runs a special ``init_param(x)`` pass on one batch whose
updates rescale every weight-normed layer's ``g`` and ``b``
(``CT_MNIST.py:64-66``, ``CT_CIFAR.py:101-103``).  Here ``init_pass(updates)``
calls the model once with ``init_updates=updates``: each weight-normed layer
standardises its output inside the pass (so the layers after it see
initialised statistics) and writes its new ``.g`` and ``.b`` into
``updates``; :func:`data_dependent_init` merges them into the parameters.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["data_dependent_init"]


def data_dependent_init(params: dict, init_pass: Callable[[dict], object]) -> dict:
    """``params`` with the ``g``/``b`` updates of ``init_pass`` applied (a
    new dict; no gradient is taken).  Raises ``KeyError`` on an update for a
    parameter ``params`` does not hold."""
    updates: dict = {}
    with torch.no_grad():
        init_pass(updates)
    out = dict(params)
    for k, v in updates.items():
        if k not in out:
            raise KeyError(f"init update for unknown param {k!r}")
        out[k] = v.to(out[k].dtype).reshape(out[k].shape)
    return out
