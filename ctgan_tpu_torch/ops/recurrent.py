"""Recurrent cells (counterpart of ``ctgan_tpu/ops/recurrent.py:20-88``,
the LSUN fork's ``gru.py`` and ``rnn.py``): no model of the apps uses them.

``params`` holds the cells' weights under the JAX names: ``<name>.Gates``
and ``<name>.Candidate`` (a GRU step), ``<name>.InputToHidden`` (a tanh
RNN step), each a linear layer's ``.W`` (``[out, in]``, ``bridge``) and
``.b``; a whole sequence's cell is ``<name>.Step`` and its learned initial
state ``<name>.h0``.  The time loop is a Python loop over ``T`` (the JAX
package runs ``lax.scan``).
"""

from __future__ import annotations

import torch

from .linear import linear

__all__ = ["gru", "gru_step", "rnn", "rnn_step"]


def _linear(params: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return linear(x, params[name + ".W"], params[name + ".b"])


def gru_step(params: dict, name: str, x_t: torch.Tensor, h_prev: torch.Tensor) -> torch.Tensor:
    """One GRU step on ``[N, D]`` and ``[N, H]``: the update and reset
    gates, then the candidate of the reset state."""
    gates = torch.sigmoid(_linear(params, name + ".Gates", torch.cat([x_t, h_prev], dim=1)))
    update, reset = gates.chunk(2, dim=1)
    candidate = torch.tanh(_linear(params, name + ".Candidate", torch.cat([x_t, reset * h_prev], dim=1)))
    return (update * candidate) + ((1.0 - update) * h_prev)


def rnn_step(params: dict, name: str, x_t: torch.Tensor, h_prev: torch.Tensor) -> torch.Tensor:
    """One tanh RNN step."""
    return torch.tanh(_linear(params, name + ".InputToHidden", torch.cat([x_t, h_prev], dim=1)))


def _run(step, params: dict, name: str, inputs: torch.Tensor, h0: torch.Tensor | None) -> torch.Tensor:
    n = inputs.shape[0]
    h = params[name + ".h0"].expand(n, -1) if h0 is None else h0
    hs = []
    for t in range(inputs.shape[1]):
        h = step(params, name + ".Step", inputs[:, t], h)
        hs.append(h)
    return torch.stack(hs, dim=1)


def gru(params: dict, name: str, inputs: torch.Tensor, h0: torch.Tensor | None = None) -> torch.Tensor:
    """A GRU over ``[N, T, D]`` -> ``[N, T, H]``, from ``h0`` (default the
    learned ``<name>.h0``)."""
    return _run(gru_step, params, name, inputs, h0)


def rnn(params: dict, name: str, inputs: torch.Tensor, h0: torch.Tensor | None = None) -> torch.Tensor:
    """A tanh RNN over ``[N, T, D]`` -> ``[N, T, H]``."""
    return _run(rnn_step, params, name, inputs, h0)
