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
uninterrupted run draws, with no generator state in the file.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.dropout import make_mask
from ..kernels.dropout import dropout_mask_reference

__all__ = ["Randomness"]


class Randomness:
    """Seeded draws for a run on ``device``.

    Dense draws come from a ``torch.Generator`` on ``generator_device``
    (default: ``device``) and are moved to ``device``; drawing on the CPU
    for two devices gives both the same numbers.  Each dropout mask gets a
    fresh 32-bit seed from a host NumPy generator, so no draw waits on the
    device.  ``cuda_dropout=False`` makes masks with the kernel's plain
    version (the same bits, without the kernel).
    """

    def __init__(self, seed: int, device, *, generator_device=None, cuda_dropout: bool = True):
        self.seed = seed
        self.device = torch.device(device)
        gen_device = torch.device(generator_device) if generator_device is not None else self.device
        self._gen_device = gen_device
        self._gen = torch.Generator(device=gen_device)
        self._gen.manual_seed(seed)
        self._seeds = np.random.default_rng(seed)
        self._cuda_dropout = cuda_dropout

    def for_step(self, step: int) -> "Randomness":
        """A fresh provider for training step ``step``, seeded from
        ``(seed, step)``."""
        derived = int(np.random.SeedSequence([self.seed, step]).generate_state(1, np.uint64)[0] >> 1)
        return Randomness(derived, self.device, generator_device=self._gen_device,
                          cuda_dropout=self._cuda_dropout)

    def _to(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device)

    def noise(self, n: int, dim: int) -> torch.Tensor:
        return self._to(torch.randn(n, dim, generator=self._gen, device=self._gen_device))

    def labels(self, n: int, n_labels: int) -> torch.Tensor:
        return self._to(torch.randint(0, n_labels, (n,), generator=self._gen, device=self._gen_device))

    def dequant(self, shape) -> torch.Tensor:
        """U[0, 1/128) added to the rescaled uint8 reals."""
        u = torch.rand(shape, generator=self._gen, device=self._gen_device)
        return self._to(u * (1.0 / 128))

    def gp_alpha(self, n: int) -> torch.Tensor:
        """One interpolation weight per example, ``[n, 1]``."""
        return self._to(torch.rand(n, 1, generator=self._gen, device=self._gen_device))

    def dropout_mask(self, shape, keep_prob, dtype: torch.dtype, device) -> torch.Tensor:
        seed = int(self._seeds.integers(0, 1 << 32))
        if self._cuda_dropout:
            return make_mask(seed, shape, keep_prob, dtype, device)
        return dropout_mask_reference(seed, shape, keep_prob, dtype, device)
