"""Device-resident sampler (counterpart of
``ctgan_tpu/data/iterator.py::DeviceSampler``).

The uint8 set lives on the device.  Each iteration takes the next
``critic_iters * batch_size`` slots of a per-epoch permutation, as
``[K, B, ...]`` stacks, so no data crosses from the host while training.
"""

from __future__ import annotations

import torch

__all__ = ["DeviceSampler"]


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
