"""Batch-norm moving statistics recalibrated before an evaluation
(counterpart of ``ctgan_tpu/train/recalibrate.py:23-44``).

Run a number of training batches through the model with batch norm's
``update_stats``, so that the moving statistics are those of the current
weights, then evaluate with ``mode="moving"`` (``ops.norm.batchnorm``; the
cumulative ``t/(t+1)`` blend).  The JAX package threads the statistics
through its store's mutable state; here they are the dict the model call
takes and returns.
"""

from __future__ import annotations

from typing import Callable, Iterable

__all__ = ["recalibrate_bn"]


def recalibrate_bn(params: dict, model_call: Callable, batches: Iterable, rand=None, *, reset: bool = True,
                   state: dict | None = None) -> dict:
    """The batch-norm state after ``model_call(params, batch, bn_state,
    rand) -> bn_state`` (which runs its batch norms with ``update_stats``
    on ``bn_state`` and returns the new one) has run over ``batches``.
    Batch ``i`` draws from ``rand.for_step(i)`` where ``rand`` is a
    ``core.rng.Randomness`` (the JAX package folds ``i`` into its key), else
    from ``rand``.  ``reset`` starts from empty statistics (the reference
    restarts ``stats_iter`` each sweep), else from ``state``."""
    bn_state: dict = {} if reset or state is None else dict(state)
    for i, batch in enumerate(batches):
        draws = rand.for_step(i) if hasattr(rand, "for_step") else rand
        bn_state = dict(model_call(params, batch, bn_state, draws))
    return bn_state
