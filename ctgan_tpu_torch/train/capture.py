"""A training step captured in one CUDA graph: the port's counterpart of
``jax.jit(step_fn, donate_argnums=0)`` (``ctgan_tpu/train/loop.py:107-110``).

:class:`CapturedStep` wraps ``fn(state, *inputs, rand)``, a step that
updates ``state`` in place, draws through ``rand.for_step(state.step)`` and
advances ``state.step`` by one.  Called with ``(state, *inputs)``:

1. warm-up: the first calls run eagerly as real steps (on a side stream on
   the card), through a recording :class:`~ctgan_tpu_torch.core.rng.StaticRandomness`,
   until one has run at a step of at least 1 (the GAN trainers skip G's
   update at step 0, so step 0's program differs);
2. the next call fills the static buffers with its step's draws, host values
   and inputs, captures ``fn`` on them in a ``torch.cuda.CUDAGraph`` and
   replays it: the step's result, with ``fn``'s outputs kept as static
   tensors;
3. every later call fills the buffers for ``state.step`` (one pinned-host to
   device copy, plus a device copy per input already on the card) and
   replays the graph, then advances ``state.step``.

Each replay gives the bits of the eager step: the same kernels on the same
values.  The Python counters of the two CUDA kernels do not see a replay,
so each replay adds the launches the capture recorded.  Another ``state``
object (a loop that loaded a checkpoint) starts again at 1.  A capture that
fails raises with the step's name; nothing falls back to eager.

``graph=False`` (the CPU's tests) runs ``fn`` eagerly on the static buffers
after the same warm-up: what the graph records, driven eagerly.

Capturing runs with ``capture_error_mode="global"``: the threads that run
beside a training step (``utils.watchdog``, ``data.images_dir.prefetch``,
``data.native``'s workers) make no CUDA calls, so any CUDA call that is not
safe during a capture is an error of the step.

A step over a mesh of processes (``parallel``) holds collectives.  NCCL's
are captured with the step: the warm-up iterations run them eagerly on the
capture's stream, and one more all-reduce there right before the capture
makes sure the communicator exists and has run on that stream's device;
every collective of the step then runs on the capturing stream's work.
gloo's cannot be captured: :func:`step_runner` runs such a step eagerly and
says so (no silent downgrade).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..core.rng import Randomness, StaticRandomness, host_to_device
from ..kernels.dropout import dropout_mask, philox_uniform

__all__ = ["CapturedStep", "flatten", "step_runner", "to_device", "unflatten"]

_COUNTERS = (dropout_mask, philox_uniform)


def flatten(tree) -> list:
    """The leaves of nested tuples and lists, in order."""
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in flatten(sub)]
    return [tree]


def unflatten(tree, leaves) -> Any:
    """``tree`` with its leaves replaced from the iterator ``leaves``."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(unflatten(sub, leaves) for sub in tree)
    return next(leaves)


def to_device(tree, device) -> Any:
    """``tree`` with its host tensors copied to ``device`` (pinned, not
    blocking)."""
    move = lambda x: host_to_device(x, device) if isinstance(x, torch.Tensor) and x.device.type == "cpu" else x
    return unflatten(tree, iter([move(x) for x in flatten(tree)]))


class CapturedStep:
    """``fn(state, *inputs, rand)`` run as one CUDA graph replay per call
    on ``rand``'s device (see the module's docstring); ``rand`` is the
    run's base :class:`~ctgan_tpu_torch.core.rng.Randomness`."""

    def __init__(self, fn: Callable, rand: Randomness, *, name: str, graph: bool | None = None, mesh=None):
        self.fn, self.name, self.device, self.mesh = fn, name, rand.device, mesh
        self.graph = self.device.type == "cuda" if graph is None else graph
        if self.graph and self.device.type != "cuda":
            raise ValueError(f"{name}: a CUDA graph needs a CUDA device, not {self.device}")
        if self.graph and mesh is not None and mesh.backend != "nccl":
            raise ValueError(f"{name}: {mesh.backend} collectives cannot be captured in a CUDA graph")
        self.provider = StaticRandomness(rand.seed, rand.device, cuda_dropout=rand._cuda_dropout,
                                         rank=rand.rank, world=rand.world)
        self.stream = torch.cuda.Stream(self.device) if self.graph else None
        self.launches = (0,) * len(_COUNTERS)  # recorded by the capture: added on each replay
        self.warmup_calls = 0
        self._state = None
        self._reset()

    def _reset(self) -> None:
        self.provider.record()
        self._cuda_graph = self._outputs = None
        self._structure = None

    @property
    def captured(self) -> bool:
        return self._cuda_graph is not None

    def __call__(self, state, *inputs):
        if state is not self._state:
            self._state = state
            self._reset()
        if self.provider.program is None:
            return self._warmup(state, inputs)
        if self.graph and not self.captured:
            return self._capture(state, inputs)
        return self._replay(state, inputs)

    def _side(self):
        """Run on the side stream, ordered after and before the current one."""
        if not self.graph:
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def ctx():
            current = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                yield
            current.wait_stream(self.stream)

        return ctx()

    def _check_step(self, state, step: int, what: str) -> None:
        if state.step != step + 1:
            raise RuntimeError(f"{self.name}: the {what} went from step {step} to {state.step}; a captured step "
                               "advances state.step by one")

    def _warmup(self, state, inputs):
        step = state.step
        self.provider.record()
        with self._side():
            out = self.fn(state, *to_device(inputs, self.device), self.provider)
        self._check_step(state, step, "warm-up step")
        recorder = self.provider.recorder
        if recorder is not None and recorder.step != step:
            raise RuntimeError(f"{self.name}: the step drew for step {recorder.step} at step {step}")
        self.warmup_calls += 1
        if step >= 1:
            self._structure = inputs
            self.provider.freeze(flatten(inputs))
        return out

    def _static_inputs(self, step: int, inputs) -> tuple:
        leaves = self.provider.fill(step, flatten(inputs))
        return unflatten(self._structure, iter(leaves))

    def _consumed(self) -> None:
        views = self.provider.views
        used = 0 if views is None else views.used
        if used != len(self.provider.program):
            raise RuntimeError(f"{self.name}: the step took {used} of the {len(self.provider.program)} draws "
                               "and host values its warm-up step took")

    def _warm_communicator(self) -> None:
        """One eager all-reduce over the mesh on the capture's stream."""
        with torch.cuda.stream(self.stream):
            dist.all_reduce(torch.zeros(1, device=self.device), group=self.mesh.world_group)
        self.stream.synchronize()

    def _capture(self, state, inputs):
        step = state.step
        if self.mesh is not None:
            self._warm_communicator()
        static = self._static_inputs(step, inputs)
        before = [c.launches for c in _COUNTERS]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="global"):
                out = self.fn(state, *static, self.provider)
        except Exception as exc:
            raise RuntimeError(f"capturing {self.name} at step {step} failed: {exc}") from exc
        finally:
            self.launches = tuple(c.launches - b for c, b in zip(_COUNTERS, before))
            for c, b in zip(_COUNTERS, before):
                c.launches = b
        self._check_step(state, step, "captured step")
        self._consumed()
        self._cuda_graph, self._outputs = graph, out
        self._launch()
        return out

    def _launch(self) -> None:
        self._cuda_graph.replay()
        for c, n in zip(_COUNTERS, self.launches):
            c.launches += n

    def _replay(self, state, inputs):
        step = state.step
        static = self._static_inputs(step, inputs)
        if not self.graph:
            out = self.fn(state, *static, self.provider)
            self._check_step(state, step, "step")
            self._consumed()
            return out
        self._launch()
        state.step = step + 1
        return self._outputs


def step_runner(fn: Callable, rand, *, name: str, jit_step: bool = True, mesh=None) -> Callable:
    """``run(state, *inputs)`` -> ``fn``'s outputs: a :class:`CapturedStep`
    where ``jit_step`` and ``rand`` is a ``Randomness`` on the card, else
    ``fn(state, *inputs, rand)`` eagerly, host tensors of ``inputs`` moved
    to ``rand``'s device first.  A step over a ``mesh`` whose backend is not
    NCCL (gloo) runs eagerly: its collectives cannot be captured, and the
    rule is printed."""
    device = rand.device if isinstance(rand, Randomness) else None
    if jit_step and device is not None and device.type == "cuda":
        if mesh is not None and mesh.backend != "nccl":
            print(f"{name}: {mesh.backend} collectives cannot be captured in a CUDA graph: "
                  f"the step runs eagerly (jit_step=False)")
        else:
            return CapturedStep(fn, rand, name=name, mesh=mesh)
    if device is not None:
        return lambda state, *inputs: fn(state, *to_device(inputs, device), rand)
    return lambda state, *inputs: fn(state, *inputs, rand)
