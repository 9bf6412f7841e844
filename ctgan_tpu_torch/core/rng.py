"""Randomness of a training step, behind one provider.

The JAX package derives every random draw from ``jax.random`` keys
(``ctgan_tpu/core/rng.py``); PyTorch's generators cannot give the same
numbers.  So the port asks one object for each draw: latent noise, fake
labels, dequantisation noise, gradient-penalty alphas and dropout masks.
:class:`Randomness` is the default; a parity test passes an object with the
same methods that hands out the JAX package's own draws.

A training run asks :meth:`Randomness.for_step` for each iteration's draws:
they are a function of ``(seed, step)`` alone, as the JAX package folds the
step into its base key, so a run resumed from a checkpoint draws what an
uninterrupted run draws, with no generator state in the file.  They do not
depend on the device either, as the JAX package's draws do not depend on the
platform: a checkpoint written on the card and resumed on the CPU goes on
with the same data and noise.

Each provider draws its Philox seeds up front into a *seed table* of
``SEED_SLOTS`` slots on its device, one pinned copy: the k-th mask or
dequantisation draw reads slot k.  The kernels read the seed from the table,
so a CUDA graph captured against a static table draws a step's masks and
noise once that step's table is copied into it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.dropout import dropout_mask_reference, philox_uniform, seed_table
from ..ops.dropout import make_mask

__all__ = ["Randomness", "SEED_SLOTS"]

# Philox draws a provider can hand out.  A flagship iteration takes 38 (33
# masks and 5 dequantisation draws), its dev cost 7; a 64 px iteration 63
# masks (3 in the G substep, 12 in each of 5 critic substeps).
SEED_SLOTS = 128


class Randomness:
    """Seeded draws for a run on ``device``, the same on every device.

    * Latent noise, labels, GP alphas and per-image flips (small) come
      from a CPU ``torch.Generator`` and go to ``device`` in one pinned,
      non-blocking copy each.
    * Dequantisation noise (a uniform per pixel, the large draw) and dropout
      masks come from Philox keyed on a 32-bit seed of a host NumPy
      generator: the CUDA kernels on the card, their plain versions on the
      CPU, bit for bit the same.  The ``SEED_SLOTS`` seeds are drawn here,
      in order, into ``seed_values`` (host) and ``seeds`` (the table on
      ``device``); each Philox draw takes the next slot, and one past the
      last raises.  One array draw of the seeder gives what as many scalar
      draws give, so slot k holds the same seed whatever ``SEED_SLOTS`` is.  ``cuda_dropout=False`` makes masks with the plain
      version on any device.
    """

    def __init__(self, seed: int, device, *, cuda_dropout: bool = True):
        self.seed = seed
        self.device = torch.device(device)
        self._gen = torch.Generator()
        self._gen.manual_seed(seed)
        seeder = np.random.default_rng(seed)
        self.seed_values = seeder.integers(0, 1 << 32, size=SEED_SLOTS).astype(np.uint32)
        self.seeds = self._to(seed_table(self.seed_values))
        self._slot = 0
        self._cuda_dropout = cuda_dropout

    def for_step(self, step: int) -> "Randomness":
        """A fresh provider for training step ``step``, seeded from
        ``(seed, step)``."""
        derived = int(np.random.SeedSequence([self.seed, step]).generate_state(1, np.uint64)[0] >> 1)
        return Randomness(derived, self.device, cuda_dropout=self._cuda_dropout)

    def _to(self, t: torch.Tensor) -> torch.Tensor:
        """A host draw on the device: on the card one copy from pinned
        memory that does not block the host (a fresh pinned tensor each
        time, so no later draw overwrites one in flight)."""
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def take_slot(self) -> int:
        """The next slot of the seed table."""
        if self._slot == SEED_SLOTS:
            raise RuntimeError(f"a provider hands out {SEED_SLOTS} Philox seeds; take a fresh one "
                               "(for_step) for more draws")
        self._slot += 1
        return self._slot - 1

    def noise(self, n: int, dim: int) -> torch.Tensor:
        return self._to(torch.randn(n, dim, generator=self._gen))

    def labels(self, n: int, n_labels: int) -> torch.Tensor:
        return self._to(torch.randint(0, n_labels, (n,), generator=self._gen))

    def dequant(self, shape) -> torch.Tensor:
        """U[0, 1/128) added to the rescaled uint8 reals."""
        return philox_uniform(self.seeds, tuple(shape), 1.0 / 128, self.device, slot=self.take_slot())

    def gp_alpha(self, n: int) -> torch.Tensor:
        """One interpolation weight per example, ``[n, 1]``."""
        return self._to(torch.rand(n, 1, generator=self._gen))

    def flip(self, n: int) -> torch.Tensor:
        """Whether to flip each of ``n`` images left to right, each with
        probability 1/2 (``ctgan_tpu/data/augment.py:22-30``)."""
        return self._to(torch.rand(n, generator=self._gen) < 0.5)

    def dropout_mask(self, shape, keep_prob, dtype: torch.dtype, device) -> torch.Tensor:
        slot = self.take_slot()
        if self._cuda_dropout:
            return make_mask(self.seeds, shape, keep_prob, dtype, device, slot=slot)
        return dropout_mask_reference(int(self.seed_values[slot]), shape, keep_prob, dtype, device)
