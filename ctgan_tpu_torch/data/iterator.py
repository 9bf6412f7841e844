"""Data iterators (counterpart of ``EpochIterator`` and ``DeviceSampler`` in
``ctgan_tpu/data/iterator.py``).

* :class:`EpochIterator`: shuffled epochs of host arrays, drop-last, with
  the JAX package's NumPy permutations, so both give the same batches.
* :func:`stack_batches`: ``[K, ...]`` stacks of K consecutive batches of
  a host iterator, one per critic substep.
* :class:`DeviceSampler`: the set lives on the device.  Each iteration
  takes the next ``critic_iters * batch_size`` slots of a per-epoch
  permutation, as ``[K, B, ...]`` stacks, so no data crosses from the host
  while training.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

__all__ = ["DeviceSampler", "EpochIterator", "epoch_batches", "stack_batches"]


class EpochIterator:
    """Shuffled batches of aligned arrays; a fresh permutation
    (``default_rng((seed, epoch))``) each epoch, fixed batch size."""

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int, seed: int = 0):
        n = len(arrays[0])
        if any(len(a) != n for a in arrays) or n < batch_size:
            raise ValueError(f"arrays of unequal length, or fewer than {batch_size} rows")
        self.arrays = [np.ascontiguousarray(a) for a in arrays]
        self.batch_size, self.seed, self.epoch, self.cursor = batch_size, seed, 0, 0
        self._perm = self._epoch_perm(0)

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        return np.random.default_rng((self.seed, epoch)).permutation(len(self.arrays[0]))

    def __iter__(self):
        return self

    def __next__(self):
        if self.cursor + self.batch_size > len(self._perm):
            self.epoch, self.cursor = self.epoch + 1, 0
            self._perm = self._epoch_perm(self.epoch)
        idx = self._perm[self.cursor:self.cursor + self.batch_size]
        self.cursor += self.batch_size
        out = tuple(a[idx] for a in self.arrays)
        return out[0] if len(out) == 1 else out

    def batches_per_epoch(self) -> int:
        return len(self.arrays[0]) // self.batch_size


def epoch_batches(arrays: Sequence[np.ndarray], batch_size: int, seed: int):
    """A factory of generators of one epoch's batches of ``arrays`` (the
    reference's ``tflib`` loaders), each call the same epoch."""

    def gen():
        it = EpochIterator(arrays, batch_size, seed=seed)
        for _ in range(it.batches_per_epoch()):
            yield next(it)

    return gen


def stack_batches(it: Iterator, k: int):
    """``[K, ...]`` stacks of ``k`` consecutive batches of ``it`` (tuples
    stacked field by field), ``ctgan_tpu/data/iterator.py:100-107``."""
    while True:
        parts = [next(it) for _ in range(k)]
        if isinstance(parts[0], tuple):
            yield tuple(np.stack([p[i] for p in parts]) for i in range(len(parts[0])))
        else:
            yield np.stack(parts)


class DeviceSampler:
    def __init__(self, arrays, batch_size: int, critic_iters: int = 1, seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        self.arrays = [torch.as_tensor(a).to(self.device) for a in arrays]
        self.n = int(self.arrays[0].shape[0])
        self.batch_size = batch_size
        self.k = critic_iters
        self.seed = seed
        self.per_iter = batch_size * critic_iters
        self.iters_per_epoch = max(1, self.n // self.per_iter)
        self._perm_cache: tuple[int, torch.Tensor] | None = None

    def host_perm(self, epoch: int) -> torch.Tensor:
        """The port's own (seed, epoch)-deterministic shuffle, drawn on the
        host as the JAX package draws its permutation
        (``ctgan_tpu/data/iterator.py:29-47``): the same on every device.
        (The JAX package draws it with ``jax.random``; parity tests pass
        that one to :meth:`sample`.)"""
        gen = torch.Generator()
        gen.manual_seed(self.seed * 1_000_003 + epoch)
        return torch.randperm(self.n, generator=gen)

    def epoch_perm(self, epoch: int) -> torch.Tensor:
        """:meth:`host_perm` on the device, copied once and cached for the
        epoch."""
        if self._perm_cache is None or self._perm_cache[0] != epoch:
            self._perm_cache = (epoch, self.host_perm(epoch).to(self.device))
        return self._perm_cache[1]

    def sample(self, step: int, perm: torch.Tensor | None = None):
        """``[K, B, ...]`` batches of every array for iteration ``step``."""
        if perm is None:
            perm = self.epoch_perm(step // self.iters_per_epoch)
        start = (step % self.iters_per_epoch) * self.per_iter
        idx = perm[start:start + self.per_iter].to(self.device)
        outs = [a[idx].reshape((self.k, self.batch_size) + tuple(a.shape[1:])) for a in self.arrays]
        return outs[0] if len(outs) == 1 else tuple(outs)
