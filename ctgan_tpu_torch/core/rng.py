"""Randomness of a training step, behind one provider.

The JAX package derives every random draw from ``jax.random`` keys
(``ctgan_tpu/core/rng.py``); PyTorch's generators cannot give the same
numbers.  So the port asks one object for each draw: latent noise, fake
labels, dequantisation noise, gradient-penalty alphas, dropout masks, and
the semi-supervised apps' Gaussian noise, uniform latents and crops.
:class:`Randomness` is the default; a parity test passes an object with the
same methods that hands out the JAX package's own draws.  The provider also
carries the values the host computes for a step deep inside it
(``from_host``: the optimisers' scalars); a step's data (a batch's
indices, a host feed's stack) is an input of the step instead.

A training run asks :meth:`Randomness.for_step` for each iteration's draws:
they are a function of ``(seed, step)`` alone, as the JAX package folds the
step into its base key, so a run resumed from a checkpoint draws what an
uninterrupted run draws, with no generator state in the file.  They do not
depend on the device either, as the JAX package's draws do not depend on the
platform: a checkpoint written on the card and resumed on the CPU goes on
with the same data and noise.

Which provider a run's iteration takes: an eager step (the CPU, or
``jit_step=False``) a fresh ``Randomness(seed).for_step(step)``, each host
draw copied on its own.  A captured step (``train.capture.CapturedStep``, the
default on the card) a :class:`StaticRandomness`: its warm-up step records
the sequence of host draws and host values; each later step's draws, made by
the same generator calls in the same order, its seed table and its host
values are packed into one pinned host buffer and copied to one static
device buffer, which the CUDA graph reads through fixed views.

Each provider draws its Philox seeds up front into a *seed table* of
``SEED_SLOTS`` slots on its device: the k-th mask or dequantisation draw
reads slot k.  The kernels read the seed from the table, so a graph captured
against the static buffer's table draws a step's masks and noise once that
step's table is copied in.

A rank's rows.  In a data-parallel run (``parallel``) each of ``world``
processes trains on its rows of the global batch, and a provider made with
``rank`` and ``world`` hands out the rank's rows of the draws the
one-process run makes: a host draw is drawn at its global shape (``world``
times the rows, from the same generator) and sliced; a Philox draw (a mask,
the dequantisation noise) launches the kernels on the rank's *row segments*
of the global tensor.  A pass whose global batch is ``k`` blocks, each
split over the ranks (the fused CT pass ``[real; fake; real; fake]``: 4),
runs under :meth:`Randomness.rows`; every other draw is one block.  The seed
table is the same on every rank.  With ``world`` 1 every draw is whole, as
before.

A pass drawn again.  A recomputed pass (``train.remat``: D's forward run
again in the backward, outside the step's code and its ``rows`` blocks)
must draw what the pass drew the first time, and must not move the step's
provider on.  :meth:`Randomness.mark` takes the provider's cursor at the
start of the pass (the next seed slot, the next recorded draw of a static
provider, the rows' blocks) and :meth:`Randomness.replay` gives a provider
that hands out the same draws again from it: a mask relaunches its kernel on
the same slot and segments (the same bits), a static provider's draw is the
same view of its buffer.  A replay makes no new host draw: a generator's
draws cannot be given twice, and a recomputed pass that asks for one raises.
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..kernels.dropout import dropout_mask_reference, philox_uniform, seed_table, whole
from ..ops.dropout import make_mask

__all__ = ["Mark", "Randomness", "SEED_SLOTS", "StaticRandomness", "derive_seed", "host_to_device", "pass_rows",
           "row_segments"]

# Philox draws a provider can hand out.  A flagship iteration takes 38 (33
# masks and 5 dequantisation draws), its dev cost 7; a 64 px iteration 63
# masks (3 in the G substep, 12 in each of 5 critic substeps); a
# semi-supervised CIFAR-10 step 18.
SEED_SLOTS = 128
RING = 3  # pinned host buffers of a static provider, each reused once its copy has run
_ALIGN = 256  # bytes: each part of a step's buffer starts on this boundary


def derive_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s provider."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


def host_to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``: on the card one copy from pinned memory
    that does not block the host (a fresh pinned tensor unless ``t`` is
    pinned, so no later draw overwrites one in flight)."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def row_segments(shape, rank: int, world: int, blocks: int = 1) -> list[tuple[int, int]]:
    """The ``(start, count)`` element ranges of the global tensor that rank
    ``rank`` of ``world`` holds as its local ``shape``, for a pass of
    ``blocks`` equal blocks each split over the ranks by rows; adjacent
    ranges merged (``world`` 1: the whole tensor, one range)."""
    n, row = shape[0], math.prod(shape[1:])
    if n % blocks:
        raise ValueError(f"{n} rows do not split into {blocks} blocks")
    m = n // blocks
    segs: list[list[int]] = []
    for b in range(blocks):
        start = (b * m * world + rank * m) * row
        if segs and segs[-1][0] + segs[-1][1] == start:
            segs[-1][1] += m * row
        else:
            segs.append([start, m * row])
    return [(a, c) for a, c in segs]


def pass_rows(rand, blocks: int):
    """``rand.rows(blocks)`` where the provider lays draws out by rows, else
    nothing (a test's injected draws of one process)."""
    rows = getattr(rand, "rows", None)
    return rows(blocks) if rows is not None else contextlib.nullcontext()


def _rank_rows(make: Callable, rank: int, world: int) -> Callable:
    """The ``make`` of a host draw that fills ``out`` with rank ``rank``'s
    rows of the draw ``make`` makes at ``world`` times the rows."""
    if world == 1:
        return make

    def local(g, step, out):
        n = out.shape[0]
        full = torch.empty((n * world, *out.shape[1:]), dtype=out.dtype)
        make(g, step, full)
        out.copy_(full[rank * n:(rank + 1) * n])

    return local


class Mark(NamedTuple):
    """A provider's cursor (:meth:`Randomness.mark`): the next seed slot,
    the next recorded draw (a static provider's; 0 elsewhere) and the
    blocks of the pass's rows."""

    slot: int
    used: int
    blocks: int


def _seed_values(seed: int) -> np.ndarray:
    """``SEED_SLOTS`` uint32 Philox seeds of ``seed``.  One array draw gives
    what as many scalar draws give, so slot k holds the same seed whatever
    ``SEED_SLOTS`` is."""
    return np.random.default_rng(seed).integers(0, 1 << 32, size=SEED_SLOTS).astype(np.uint32)


class Randomness:
    """Seeded draws for a run on ``device``, the same on every device.

    * Latent noise, labels, GP alphas, per-image flips and crop offsets
      (small), and the semi-supervised MNIST classifier's Gaussian noise
      (1.82 M normals per step at its defaults), come from a CPU
      ``torch.Generator``, drawn into pinned memory and copied to
      ``device`` without blocking: a Box-Muller draw on the card would not
      give the CPU's bits.
    * Dequantisation noise (a uniform per pixel, the large draw) and dropout
      masks come from Philox keyed on a 32-bit seed of a host NumPy
      generator: the CUDA kernels on the card, their plain versions on the
      CPU, bit for bit the same.  The ``SEED_SLOTS`` seeds are drawn here,
      in order, into ``seed_values`` (host) and ``seeds`` (the table on
      ``device``); each Philox draw takes the next slot, and one past the
      last raises.  ``cuda_dropout=False`` makes masks with the plain
      version on any device.
    * ``rank`` and ``world``: the rank's rows of each draw (the module's
      docstring).
    * :meth:`mark` and :meth:`replay`: the draws of a pass again (the
      module's docstring).
    """

    _replaying = False  # a replay's copy: re-issues draws, makes no host draw

    def __init__(self, seed: int, device, *, cuda_dropout: bool = True, rank: int = 0, world: int = 1):
        self.seed = seed
        self.device = torch.device(device)
        self._gen = torch.Generator()
        self._gen.manual_seed(seed)
        self.seed_values = _seed_values(seed)
        self.seeds = self._to(seed_table(self.seed_values))
        self._slot = 0
        self._cuda_dropout = cuda_dropout
        self.rank, self.world, self._blocks = rank, world, 1

    def for_step(self, step: int) -> "Randomness":
        """A fresh provider for training step ``step``, seeded from
        ``(seed, step)``."""
        return Randomness(derive_seed(self.seed, step), self.device, cuda_dropout=self._cuda_dropout,
                          rank=self.rank, world=self.world)

    def for_rank(self, index: int) -> "Randomness":
        """A provider of draws of its own for device ``index`` of a mesh
        (``parallel.make_spmd_trainer``'s per-device draws), whole on each
        device, seeded from ``(seed, 2**40 + index)``."""
        return Randomness(derive_seed(self.seed, (1 << 40) + index), self.device, cuda_dropout=self._cuda_dropout)

    @contextlib.contextmanager
    def rows(self, blocks: int):
        """Draws inside are of a pass whose global batch is ``blocks`` equal
        blocks, each split over the ranks by rows."""
        before, self._blocks = self._blocks, blocks
        try:
            yield self
        finally:
            self._blocks = before

    def mark(self) -> Mark:
        """The cursor at the start of a pass, for :meth:`replay`."""
        return Mark(self._slot, getattr(self, "used", 0), self._blocks)

    def replay(self, mark: Mark) -> "Randomness":
        """A provider that hands out again the draws this one handed out
        from ``mark`` on (Philox draws on the same slots and segments, a
        static provider's views), apart from this one, which does not
        move."""
        again = copy.copy(self)
        again._slot, again._blocks, again._replaying = mark.slot, mark.blocks, True
        if hasattr(self, "used"):
            again.used = mark.used
        return again

    def _no_host_draw(self, kind: str) -> None:
        if self._replaying:
            raise RuntimeError(f"a replayed pass asks for a host draw ({kind}); only Philox draws and a static "
                               "provider's views can be drawn again")

    def _rows_kw(self, shape) -> dict:
        """The kernels' ``segments`` argument for a draw of local ``shape``:
        the rank's element ranges of the global draw, none for a whole
        draw."""
        segments = row_segments(tuple(shape), self.rank, self.world, self._blocks)
        return {} if whole(segments, math.prod(shape)) else {"segments": segments}

    def _to(self, t: torch.Tensor) -> torch.Tensor:
        return host_to_device(t, self.device)

    def _host(self, kind: str, shape: tuple, dtype: torch.dtype, make: Callable) -> torch.Tensor:
        """A host draw of ``shape`` and ``dtype``: ``make(generator, step,
        out)`` fills ``out`` from its shape; the rank's rows of the draw at
        ``world`` times the rows."""
        return self._draw(kind, tuple(shape), dtype, _rank_rows(make, self.rank, self.world))

    def _draw(self, kind: str, shape: tuple, dtype: torch.dtype, make: Callable) -> torch.Tensor:
        """``make`` filling a host tensor of ``shape`` (straight into pinned
        memory on the card), moved to the device."""
        self._no_host_draw(kind)
        pinned = self.device.type == "cuda" and torch.cuda.is_available()
        out = torch.empty(shape, dtype=dtype, pin_memory=pinned)
        make(self._gen, None, out)
        return self._to(out)

    def take_slot(self) -> int:
        """The next slot of the seed table."""
        if self._slot == SEED_SLOTS:
            raise RuntimeError(f"a provider hands out {SEED_SLOTS} Philox seeds; take a fresh one "
                               "(for_step) for more draws")
        self._slot += 1
        return self._slot - 1

    def noise(self, n: int, dim: int) -> torch.Tensor:
        return self._host("noise", (n, dim), torch.float32,
                          lambda g, s, out: torch.randn(out.shape, generator=g, out=out))

    def normal(self, shape) -> torch.Tensor:
        """Standard normals of ``shape`` (``ops.noise.gaussian_noise``)."""
        return self._host("normal", tuple(shape), torch.float32,
                          lambda g, s, out: torch.randn(out.shape, generator=g, out=out))

    def uniform(self, n: int, dim: int) -> torch.Tensor:
        """U[0, 1) latents, ``[n, dim]`` (the semi-supervised generators)."""
        return self._host("uniform", (n, dim), torch.float32,
                          lambda g, s, out: torch.rand(out.shape, generator=g, out=out))

    def labels(self, n: int, n_labels: int) -> torch.Tensor:
        return self._host("labels", (n,), torch.int64,
                          lambda g, s, out: torch.randint(0, n_labels, out.shape, generator=g, out=out))

    def dequant(self, shape) -> torch.Tensor:
        """U[0, 1/128) added to the rescaled uint8 reals."""
        return philox_uniform(self.seeds, tuple(shape), 1.0 / 128, self.device, slot=self.take_slot(),
                              **self._rows_kw(shape))

    def gp_alpha(self, n: int) -> torch.Tensor:
        """One interpolation weight per example, ``[n, 1]``."""
        return self._host("gp_alpha", (n, 1), torch.float32,
                          lambda g, s, out: torch.rand(out.shape, generator=g, out=out))

    def flip(self, n: int) -> torch.Tensor:
        """Whether to flip each of ``n`` images left to right, each with
        probability 1/2 (``ctgan_tpu/data/augment.py:22-30``)."""
        return self._host("flip", (n,), torch.bool,
                          lambda g, s, out: torch.lt(torch.rand(out.shape, generator=g), 0.5, out=out))

    def crop_offsets(self, n: int, pad: int) -> torch.Tensor:
        """``[n, 2]`` (row, column) crop offsets, each uniform over
        ``[0, 2 * pad]`` (``ctgan_tpu/data/augment.py:33-56``)."""
        return self._host("crop_offsets", (n, 2), torch.int64,
                          lambda g, s, out: torch.randint(0, 2 * pad + 1, out.shape, generator=g, out=out))

    def from_host(self, fn: Callable[[int], object], step: int) -> torch.Tensor:
        """``fn(step)`` (an array or tensor the host computes for ``step``)
        on the device.  ``fn`` runs now; a static provider runs the ``fn``
        of its recorded step when it fills a later step, so ``fn`` takes
        what changes from step to step from its argument or from objects
        that outlive the step."""
        self._no_host_draw("host value")
        return self._to(torch.as_tensor(fn(step)))

    def dropout_mask(self, shape, keep_prob, dtype: torch.dtype, device) -> torch.Tensor:
        slot, rows = self.take_slot(), self._rows_kw(shape)
        if self._cuda_dropout:
            return make_mask(self.seeds, shape, keep_prob, dtype, device, slot=slot, **rows)
        return dropout_mask_reference(int(self.seed_values[slot]), shape, keep_prob, dtype, device, **rows)


class _Entry(NamedTuple):
    """One host draw or host value of a step: ``make(generator, step, out)``
    writes it into ``out`` at ``offset`` bytes of the step's buffer."""

    kind: str
    shape: tuple
    dtype: torch.dtype
    make: Callable
    offset: int = 0

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize


def _host_value(fn: Callable[[int], object], shape: tuple, dtype: torch.dtype) -> Callable:
    """The ``make`` of a host value: ``fn(step)`` checked against the
    recorded shape and dtype."""

    def make(g, step, out):
        value = torch.as_tensor(fn(step))
        if tuple(value.shape) != shape or value.dtype != dtype:
            raise RuntimeError(f"a host value of the captured step changed from {shape} {dtype} to "
                               f"{tuple(value.shape)} {value.dtype}")
        out.copy_(value)

    return make


class _Recorder(Randomness):
    """``Randomness`` of one step that records its host draws and values in
    order (an eager warm-up step of a captured run)."""

    def __init__(self, seed: int, device, *, cuda_dropout: bool, step: int, rank: int = 0, world: int = 1):
        super().__init__(seed, device, cuda_dropout=cuda_dropout, rank=rank, world=world)
        self.step, self.entries = step, []

    def _draw(self, kind, shape, dtype, make):
        self._no_host_draw(kind)
        self.entries.append(_Entry(kind, tuple(shape), dtype, make))
        return super()._draw(kind, shape, dtype, make)

    def from_host(self, fn, step):
        self._no_host_draw("host value")
        value = torch.as_tensor(fn(step))
        self.entries.append(_Entry("host", tuple(value.shape), value.dtype,
                                   _host_value(fn, tuple(value.shape), value.dtype)))
        return self._to(value)


class _Views(Randomness):
    """The draws of the step a :class:`StaticRandomness` last filled, as
    views of its device buffer, checked against the recorded sequence."""

    def __init__(self, provider: "StaticRandomness"):
        # no Randomness.__init__: the seeds are in the buffer, nothing is drawn here
        self.seed, self.device, self._cuda_dropout = provider.seed, provider.device, provider.cuda_dropout
        self.seeds, self.seed_values = provider.view(provider.seed_entry), None
        self._provider, self._slot, self.used = provider, 0, 0
        self.rank, self.world, self._blocks = provider.rank, provider.world, 1

    def _next(self, kind: str, shape=None, dtype=None) -> torch.Tensor:
        program = self._provider.program
        entry = program[self.used] if self.used < len(program) else None
        if entry is None or entry.kind != kind or shape is not None and (entry.shape, entry.dtype) != (shape, dtype):
            raise RuntimeError(f"draw {self.used} of the captured step asks for {kind} {shape} {dtype}; the "
                               f"warm-up step drew {entry and (entry.kind, entry.shape, entry.dtype)}")
        self.used += 1
        return self._provider.view(entry)

    def _draw(self, kind, shape, dtype, make):
        return self._next(kind, tuple(shape), dtype)

    def from_host(self, fn, step):
        return self._next("host")

    def dropout_mask(self, shape, keep_prob, dtype, device):
        if self._cuda_dropout:
            return super().dropout_mask(shape, keep_prob, dtype, device)
        # the plain version reads the seed from the device table: the same bits, and capturable
        return dropout_mask_reference(self.seeds, shape, keep_prob, dtype, device, slot=self.take_slot(),
                                      **self._rows_kw(shape))


class StaticRandomness:
    """The provider of a captured step: one step's draws in a static buffer.

    ``record()``: the next ``for_step(s)`` hands out a recording
    ``Randomness(seed).for_step(s)`` (bit for bit its draws); ``freeze``
    lays its host draws and values out after the seed table, then the
    ``inputs`` of the step (host tensors), each on a 256-byte boundary, and
    allocates ``RING`` pinned host buffers and the device buffer.
    ``fill(s, inputs)``: step ``s``'s draws from a fresh generator of
    ``derive_seed(seed, s)`` in the recorded order, its seeds, its host
    values and inputs go into the next pinned buffer (once the copy that
    last read it has run: a CUDA event each) and one non-blocking copy moves
    it to the device buffer.  Then ``for_step(s)`` hands out views of the
    device buffer in the recorded order, and raises where the step asks for
    other draws.  Inputs that already lie on the device are copied into
    static device tensors instead.  ``rank`` and ``world`` as for
    :class:`Randomness`: a recorded host draw keeps the rank's rows."""

    def __init__(self, seed: int, device, *, cuda_dropout: bool = True, rank: int = 0, world: int = 1):
        self.seed, self.device, self.cuda_dropout = seed, torch.device(device), cuda_dropout
        self.rank, self.world = rank, world
        self.program: list[_Entry] | None = None
        self.recorder: _Recorder | None = None
        self.views: _Views | None = None
        self.filled_step: int | None = None
        self.seed_entry = _Entry("seeds", (SEED_SLOTS,), torch.int32, None)
        self._inputs: list = []  # per input leaf: an _Entry (host), a static device tensor, or a constant
        self._hosts: list[torch.Tensor] = []
        self._events: list = []
        self._next = 0
        self.buffer: torch.Tensor | None = None

    def record(self) -> "StaticRandomness":
        self.program, self.recorder, self.views = None, None, None
        return self

    def for_step(self, step: int) -> Randomness:
        if self.program is None:
            self.recorder = _Recorder(derive_seed(self.seed, step), self.device, cuda_dropout=self.cuda_dropout,
                                      step=step, rank=self.rank, world=self.world)
            return self.recorder
        if step != self.filled_step:
            raise RuntimeError(f"the static buffer holds step {self.filled_step}'s draws, not step {step}'s")
        self.views = _Views(self)
        return self.views

    def freeze(self, inputs: list) -> None:
        """Fix the layout: the recorded step's draws and values, then the
        input leaves (tensors on the host take buffer space)."""
        entries = self.recorder.entries if self.recorder is not None else []
        offset, program, layout = 0, [], []

        def place(entry: _Entry) -> _Entry:
            nonlocal offset
            placed = entry._replace(offset=offset)
            offset += -(-entry.nbytes // _ALIGN) * _ALIGN
            return placed

        self.seed_entry = place(self.seed_entry)
        program = [place(e) for e in entries]
        for leaf in inputs:
            if isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu":
                layout.append(place(_Entry("input", tuple(leaf.shape), leaf.dtype, None)))
            elif isinstance(leaf, torch.Tensor):
                layout.append(torch.empty_like(leaf, device=self.device))
            else:
                layout.append(leaf)
        pinned = self.device.type == "cuda"
        self._hosts = [torch.empty(offset, dtype=torch.uint8, pin_memory=pinned) for _ in range(RING)]
        # an event never recorded counts as done
        self._events = [torch.cuda.Event() for _ in range(RING)] if pinned else []
        self.buffer = torch.empty(offset, dtype=torch.uint8, device=self.device)
        self.program, self._inputs, self.recorder = program, layout, None

    @staticmethod
    def _view_of(buf: torch.Tensor, entry: _Entry) -> torch.Tensor:
        return buf[entry.offset:entry.offset + entry.nbytes].view(entry.dtype).view(entry.shape)

    def view(self, entry: _Entry) -> torch.Tensor:
        """``entry`` in the device buffer."""
        return self._view_of(self.buffer, entry)

    def fill(self, step: int, inputs: list) -> list:
        """Step ``step``'s draws, seeds, host values and ``inputs`` (leaves)
        into the static buffers; returns the leaves the step reads."""
        k = self._next
        self._next = (k + 1) % RING
        if self._events:
            self._events[k].synchronize()
        host = self._hosts[k]
        seed = derive_seed(self.seed, step)
        gen = torch.Generator()
        gen.manual_seed(seed)
        self._view_of(host, self.seed_entry).copy_(torch.from_numpy(_seed_values(seed).view(np.int32)))
        for entry in self.program:
            entry.make(gen, step, self._view_of(host, entry))
        leaves = []
        for spec, leaf in zip(self._inputs, inputs, strict=True):
            if isinstance(spec, _Entry):
                if not isinstance(leaf, torch.Tensor) or (tuple(leaf.shape), leaf.dtype) != (spec.shape, spec.dtype):
                    raise RuntimeError(f"an input of the captured step changed from {spec.shape} {spec.dtype}")
                self._view_of(host, spec).copy_(leaf)
                leaves.append(self.view(spec))
            elif isinstance(spec, torch.Tensor):
                if not isinstance(leaf, torch.Tensor) or (leaf.shape, leaf.dtype) != (spec.shape, spec.dtype):
                    raise RuntimeError(f"an input of the captured step changed from {tuple(spec.shape)} {spec.dtype}")
                leaves.append(spec)
            else:
                if leaf is not spec and leaf != spec:
                    raise RuntimeError(f"a constant input of the captured step changed from {spec!r} to {leaf!r}")
                leaves.append(spec)
        if self.device.type == "cuda":
            self.buffer.copy_(host, non_blocking=True)
            self._events[k].record()
        else:
            self.buffer.copy_(host)
        for spec, leaf in zip(self._inputs, inputs):
            if isinstance(spec, torch.Tensor):
                spec.copy_(leaf)
        self.filled_step = step
        return leaves
