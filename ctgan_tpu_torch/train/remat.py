"""Recomputing the discriminator's forward in the backward (counterpart of
``ctgan_tpu/train/remat.py:34-57``).

:func:`make_remat_disc` wraps ``disc_fn(params, x, ..., rand)`` (the
trainers' D, ``rand`` its last argument) in
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the pass
keeps none of its activations, and the backward runs it again to get them.
The non-reentrant form is the one that supports ``torch.autograd.grad``
and the gradient penalty's double backward (``create_graph=True``).
Keep-probabilities and other Python values pass through as they are, as
the JAX wrapper's static tail (``n_static_tail=3``).

The masks.  The pass draws its dropout masks from ``rand``; the
recomputation runs later, in the backward, outside the step's code.  So the
wrapper marks ``rand``'s cursor when the pass starts (``rand.mark()``: the
seed slot, a static provider's view index, the rows' blocks of the pass)
and runs each recomputation on ``rand.replay(mark)``: the mask kernel is
launched again on the same seed slots and row segments and gives the same
masks, bit for bit, and the step's provider does not move.  The masks are
not stored either.  So a step draws the same masks with and without
``remat`` (the JAX wrapper derives its masks from a ``"remat"`` stream of
their own instead), and its numbers are those of the plain step.  A
provider without ``mark`` and ``replay`` is refused.

Under ``torch.no_grad()`` (the flagship's clean pass) nothing is
recomputed: the wrapper calls ``disc_fn``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["make_remat_disc"]


def make_remat_disc(disc_fn: Callable) -> Callable:
    """``disc_fn`` recomputed in the backward (the module's docstring).
    The wrapper counts the recomputations it ran in ``.recomputes``."""

    def remat_disc(params, *args):
        if not torch.is_grad_enabled():
            return disc_fn(params, *args)
        *rest, rand = args
        if not (hasattr(rand, "mark") and hasattr(rand, "replay")):
            raise TypeError(f"remat needs a provider that can replay a pass's draws (mark, replay), not "
                            f"{type(rand).__name__}")
        mark, calls = rand.mark(), [0]

        def run(params, *rest):
            calls[0] += 1
            if calls[0] == 1:
                return disc_fn(params, *rest, rand)
            remat_disc.recomputes += 1
            return disc_fn(params, *rest, rand.replay(mark))

        # the draws come from ``rand``, not from torch's generators: nothing to stash
        return checkpoint(run, params, *rest, use_reentrant=False, preserve_rng_state=False)

    remat_disc.recomputes = 0
    return remat_disc
