"""Training over a mesh of processes (counterpart of
``ctgan_tpu/parallel/spmd.py``): the trainers' collective hooks, the
library's per-device trainer :func:`make_spmd_trainer`, and the apps'
one-device-semantics step :func:`data_parallel`.

Storage and compute (the JAX package's ZeRO-style design):

* The leaves the rules match (``parallel.mesh.DEFAULT_RULES``), and their
  optimiser moments (which mirror the parameters by name), are stored as
  shards along the ``model`` dimension; the rest are replicated.
* Each substep all-gathers the sharded leaves over the model group
  (``gather_gen``/``gather_disc``), runs forward and backward on the rank's
  rows of the batch (the global batch split over all ``data x model``
  ranks), averages the gradients over the whole mesh in one flat all-reduce
  (``sync_gen_grads``/``sync_disc_grads``, before any clip, as the JAX
  trainers sync them), slices the sharded leaves' gradients back and runs
  the optimiser on the shards: every optimiser here is elementwise, so the
  update of a slice is the slice of the update.  The metrics are the mean
  over the mesh (``sync_metrics``).  Adam runs on every rank on the same
  values, so the replicated leaves stay equal on every rank.

Two semantics share these hooks:

* :func:`data_parallel` (the apps): equal to one device, as GSPMD's global
  program is in the JAX apps.  Every draw is the rank's rows of the draw the
  one-process run makes (``core.rng``: the provider's ``rank`` and
  ``world``), and batch norms take the statistics of the global batch
  (``SpmdHooks.batch_group``: the mesh's group, ``ops.norm.batch_group``).
* :func:`make_spmd_trainer` (the library's manual-SPMD trainer): per-device
  semantics, as the JAX one has.  Each rank draws its own draws
  (``rand.for_rank(rank)``, JAX's fold-in of the linear device index) and
  its batch norms see its own rows (ghost batch norm) unless a norm is given
  a group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from .collectives import all_gather_cat, flat_mean
from .mesh import DEFAULT_RULES, Mesh, effective_param_specs, local_rows, model_dim, shard_leaf

__all__ = ["SpmdHooks", "data_parallel", "fetch_full_params", "fetch_full_state", "make_hooks",
           "make_spmd_trainer", "shard_state"]


class SpmdHooks(NamedTuple):
    """Collective-insertion points handed to the trainers
    (``GanTrainer``/``AcganTrainer(..., spmd_hooks=)``).

    ``gather_*(params)``: the full leaves a substep computes with (gathered
    shards as fresh leaves that take gradients); ``sync_*_grads(grads)``:
    the gradients of the stored leaves; ``sync_metrics``: the mesh mean of
    a 0-d tensor or a dict of them; ``batch_group``: the group whose
    processes' rows batch norms normalise together (None: each its own)."""

    gather_gen: Callable[[dict], dict]
    gather_disc: Callable[[dict], dict]
    sync_gen_grads: Callable[[dict], dict]
    sync_disc_grads: Callable[[dict], dict]
    sync_metrics: Callable
    batch_group: Any = None


def _opt_specs(opt_state: dict, pspecs: dict) -> dict:
    """Spec tree of an optimiser state: moment dicts mirror the params by
    name; scalars (step counters) replicate."""
    return {k: _opt_specs(v, pspecs) if isinstance(v, dict) else pspecs.get(k, ()) for k, v in opt_state.items()}


def make_hooks(mesh: Mesh, gen_specs: dict, disc_specs: dict, *, batch_group=None) -> SpmdHooks:
    """The hooks of a trainer over ``mesh`` whose leaves are stored under
    ``gen_specs``/``disc_specs``."""

    def gather(specs):
        def f(params: dict) -> dict:
            out = {}
            for k, v in params.items():
                dim = model_dim(specs[k])
                if dim is None or mesh.model == 1:
                    out[k] = v
                else:
                    out[k] = all_gather_cat(v, dim, mesh.model_group, mesh.model).requires_grad_(True)
            return out
        return f

    def sync(specs):
        def f(grads: dict) -> dict:
            names = list(grads)
            means = flat_mean([grads[k] for k in names], mesh.world_group, mesh.world)
            return {k: shard_leaf(mesh, g, specs[k]) for k, g in zip(names, means)}
        return f

    def sync_metrics(m):
        if isinstance(m, torch.Tensor):
            return flat_mean([m], mesh.world_group, mesh.world)[0]
        names = list(m)
        return dict(zip(names, flat_mean([m[k].float() for k in names], mesh.world_group, mesh.world)))

    return SpmdHooks(gather(gen_specs), gather(disc_specs), sync(gen_specs), sync(disc_specs), sync_metrics,
                     batch_group)


def _tree_map(tree, specs, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(tree[k], specs[k], fn) for k in tree}
    return fn(tree, specs)


def fetch_full_params(params: dict, mesh: Mesh | None = None, specs: dict | None = None) -> dict:
    """The full leaves of ``params`` stored under ``specs`` on ``mesh``
    (model-sharded leaves all-gathered, so every rank of the mesh calls
    it), detached: for evaluation, sampling and checkpoints outside the
    step.  Without a mesh, the leaves as they are."""
    if mesh is None or mesh.model == 1:
        return {k: v.detach() for k, v in params.items()}
    return {k: _full(mesh, v, specs[k]) for k, v in params.items()}


def _full(mesh: Mesh, v, spec):
    if not isinstance(v, torch.Tensor):
        return v
    dim = model_dim(spec)
    if dim is None or mesh.model == 1:
        return v.detach()
    return all_gather_cat(v, dim, mesh.model_group, mesh.model)


def state_specs_of(state, gen_specs: dict, disc_specs: dict) -> dict:
    """Spec trees of a trainer state's fields (``step``: replicated)."""
    return {"gen_params": dict(gen_specs), "disc_params": dict(disc_specs),
            "gen_opt": _opt_specs(state.gen_opt, gen_specs), "disc_opt": _opt_specs(state.disc_opt, disc_specs),
            "step": ()}


def fetch_full_state(state, mesh: Mesh | None, specs: dict | None):
    """A copy of a trainer state with full leaves (params and optimiser
    moments, :func:`fetch_full_params`); every rank of the mesh calls it.
    Without a mesh, ``state`` itself."""
    if mesh is None:
        return state
    fields = {}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if isinstance(value, dict):
            value = _tree_map(value, specs[f.name], lambda v, s: _full(mesh, v, s))
        fields[f.name] = value
    return type(state)(**fields)


def shard_state(state, mesh: Mesh, specs: dict):
    """A full trainer state (a loaded checkpoint) as this rank's storage:
    each sharded leaf sliced."""
    fields = {}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if isinstance(value, dict):
            value = _tree_map(value, specs[f.name],
                              lambda v, s: shard_leaf(mesh, v, s) if isinstance(v, torch.Tensor) else v)
        fields[f.name] = value
    return type(state)(**fields)


def _trainer_cls(flavor: str):
    from ..train import AcganTrainer, GanTrainer

    if flavor == "gan":
        return GanTrainer
    if flavor == "acgan":
        return AcganTrainer
    raise ValueError(f"unknown flavor {flavor!r}")


def _sharded(mesh: Mesh, trainer_cls, gen_fn, disc_fn, cfg, gen_params: dict, disc_params: dict, rules,
             batch_group):
    """(trainer over the rank's rows, state0 with sharded storage, state
    specs)."""
    if cfg.batch_size % mesh.world:
        raise ValueError(f"batch {cfg.batch_size} not divisible by {mesh.world} devices")
    local_cfg = dataclasses.replace(cfg, batch_size=cfg.batch_size // mesh.world)
    gen_specs = effective_param_specs(mesh, gen_params, rules)
    disc_specs = effective_param_specs(mesh, disc_params, rules)
    hooks = make_hooks(mesh, gen_specs, disc_specs, batch_group=batch_group)
    trainer = trainer_cls(gen_fn, disc_fn, local_cfg, spmd_hooks=hooks)
    state0 = trainer.init_state({k: shard_leaf(mesh, v, gen_specs[k]) for k, v in gen_params.items()},
                                {k: shard_leaf(mesh, v, disc_specs[k]) for k, v in disc_params.items()})
    return trainer, state0, state_specs_of(state0, gen_specs, disc_specs)


def make_spmd_trainer(gen_fn, disc_fn, cfg, mesh: Mesh, gen_params: dict, disc_params: dict, *,
                      rules=DEFAULT_RULES, batch_axis: int = 1, flavor: str = "gan"):
    """The library's manual-SPMD trainer over ``mesh``, per-device
    semantics.  Returns ``(state0, spmd_step, state_specs)``:

    * ``state0``: this rank's trainer state, rule-matched params and their
      moments stored as model-axis shards;
    * ``spmd_step(state, real_stack[, label_stack], rand)``: one iteration
      (1 x G + K x D) on this rank's rows of the global ``[K, B, ...]``
      stack (its batch axis ``batch_axis`` split over every rank,
      data-major), every draw from ``rand.for_rank(rank)``; updates the
      state in place and returns ``(state, metrics)``, the metrics the mesh
      mean.  ``flavor='acgan'`` adds the ``[K, B]`` label stack;
    * ``state_specs``: the spec tree of each state field.

    ``cfg.batch_size`` is the global batch and must divide by the mesh
    size.  ``clip_global_norm`` is refused: the norm of sharded gradients
    needs a model-axis reduction the JAX trainer does not make either."""
    trainer_cls = _trainer_cls(flavor)
    if getattr(cfg, "clip_global_norm", None) is not None:
        raise NotImplementedError("clip_global_norm under fused SPMD needs a model-axis-corrected "
                                  "norm; use the unfused path or drop the clip")
    trainer, state0, specs = _sharded(mesh, trainer_cls, gen_fn, disc_fn, cfg, gen_params, disc_params, rules,
                                      None)

    def spmd_step(state, real_stack, *rest):
        *labels, rand = rest
        local = [local_rows(mesh, x, axis) for x, axis in zip((real_stack, *labels), (batch_axis, 1))]
        return state, trainer.step(state, *local, rand.for_rank(mesh.rank))

    return state0, spmd_step, specs


def data_parallel(mesh: Mesh, trainer_cls, gen_fn, disc_fn, cfg, gen_params: dict, disc_params: dict, *,
                  rules=DEFAULT_RULES):
    """The apps' trainer over ``mesh`` with one device's semantics: global
    batch-norm statistics over the mesh and, given a provider of the rank's
    rows (``Randomness(seed, device, rank=mesh.rank, world=mesh.world)``),
    the one-process draws.  Returns ``(trainer, state0, state_specs)``; the
    trainer's ``step`` takes this rank's rows of each batch (``[K, B /
    world, ...]``, ``parallel.mesh.local_rows``)."""
    if mesh.model > 1 and getattr(cfg, "clip_global_norm", None) is not None:
        raise NotImplementedError("clip_global_norm with model-sharded leaves needs a model-axis-corrected norm")
    return _sharded(mesh, trainer_cls, gen_fn, disc_fn, cfg, gen_params, disc_params, rules, mesh.world_group)
