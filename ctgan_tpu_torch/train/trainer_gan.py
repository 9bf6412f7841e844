"""Unconditional CT-GAN trainer (counterpart of
``ctgan_tpu/train/trainer_gan.py:44-302``).

One iteration is one generator update, skipped at step 0 as in the
reference (``if iteration > 0``), then one critic update per real batch of
the ``[K, B, D]`` stack.  The modes and their optimisers
(``ctgan_tpu/train/trainer_gan.py:75-95``):

* ``wgan-CT``/``wgan-ct``: WGAN + consistency term + gradient penalty,
  TF-Adam (linear LR decay with ``lr_decay``);
* ``wgan-gp``: WGAN + gradient penalty, the same Adam;
* ``wgan``: WGAN, RMSProp at 5e-5, D's parameters clipped into
  ``[-clip_value, clip_value]`` after each critic update;
* ``dcgan``: sigmoid cross-entropy, Adam at 2e-4 with beta1 0.5;
* ``lsgan``: least squares, RMSProp at 1e-4.

Each D pass is a separate call, as the JAX trainer makes it: real, fake,
real again for the CT, and the GP's interpolates.  A D with batch norm
normalises each call by its own batch, so concatenating passes (the
flagship's ``fuse_ct_passes``) would change the math.  ``clip_grad_value``
and ``clip_global_norm`` transform the critic's gradients before its
update; the latter reports ``gradnorm``.

Every random draw comes from the ``rand`` argument
(:class:`ctgan_tpu_torch.core.rng.Randomness` or a test's injected draws),
and so do the optimisers' per-step scalars (``optim.device_scalars``).
The state is updated in place.  :meth:`GanTrainer.dev_cost` and
:meth:`~GanTrainer.sample` are the evaluation functions
(``disc_cost_fn`` and ``sample_fn`` of the JAX trainer).

``remat`` recomputes every differentiated D pass in the backward instead of
keeping its activations (``train.remat``: the same masks, relaunched on
their slots); ``opt_state_dtype`` stores both optimisers' moments in that
dtype (``optim.with_state_dtype``), as the JAX trainer applies them
(``ctgan_tpu/train/trainer_gan.py:87-93,120-123``).

``spmd_hooks`` (``parallel.SpmdHooks``) run the substeps over a mesh of
processes at the JAX trainer's hook points
(``ctgan_tpu/train/trainer_gan.py:191-234``): each substep computes with the
gathered leaves, syncs the gradients (before any clip) and the metrics, and
updates the stored shards; batch norms inside take the hooks'
``batch_group``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import torch

from ..losses.gan import (
    consistency_term,
    dcgan_losses,
    gradient_penalty,
    lsgan_losses,
    wgan_losses,
)
from ..ops.norm import batch_group
from .optim import (
    Adam,
    RMSProp,
    clip_grads_by_global_norm,
    clip_grads_by_value,
    clip_params_by_value,
    with_state_dtype,
)
from .remat import make_remat_disc
from .schedules import linear_decay

__all__ = ["GanConfig", "GanState", "GanTrainer"]


@dataclass(frozen=True)
class GanConfig:
    mode: str = "wgan-CT"
    batch_size: int = 64
    critic_iters: int = 5
    lambda_gp: float = 10.0
    lambda_ct: float = 2.0
    factor_m: float = 0.0
    lr: float = 1e-4
    beta1: float = 0.5
    beta2: float = 0.9
    iters: int = 50000
    lr_decay: bool = False
    clip_value: float = 0.01
    gen_bs_multiple: int = 1
    remat: bool = False
    clip_global_norm: float | None = None
    clip_grad_value: float | None = None
    opt_state_dtype: str = "float32"


@dataclass
class GanState:
    """The fields of the JAX package's ``GANState``."""

    gen_params: dict
    disc_params: dict
    gen_opt: dict
    disc_opt: dict
    step: int = 0


def _make_optimizers(cfg: GanConfig):
    """(G's, D's) optimiser of ``cfg.mode``, moments in ``cfg.opt_state_dtype``."""
    if cfg.mode in ("wgan-CT", "wgan-ct", "wgan-gp"):
        lr = linear_decay(cfg.lr, cfg.iters) if cfg.lr_decay else cfg.lr
        pair = Adam(lr, cfg.beta1, cfg.beta2), Adam(lr, cfg.beta1, cfg.beta2)
    elif cfg.mode == "wgan":
        pair = RMSProp(5e-5), RMSProp(5e-5)
    elif cfg.mode == "dcgan":
        pair = Adam(2e-4, 0.5), Adam(2e-4, 0.5)
    elif cfg.mode == "lsgan":
        pair = RMSProp(1e-4), RMSProp(1e-4)
    else:
        raise ValueError(f"unknown mode {cfg.mode!r}")
    return tuple(with_state_dtype(o, cfg.opt_state_dtype) for o in pair)


class GanTrainer:
    """``gen_fn(params, n, rand, noise=None)`` -> flat images;
    ``disc_fn(params, x, rand)`` -> ``(logits, features)``."""

    def __init__(self, gen_fn: Callable, disc_fn: Callable, cfg: GanConfig, spmd_hooks=None):
        if cfg.remat:
            disc_fn = make_remat_disc(disc_fn)
        self.gen_fn, self.disc_fn, self.cfg, self.spmd_hooks = gen_fn, disc_fn, cfg, spmd_hooks
        self.gen_optimizer, self.disc_optimizer = _make_optimizers(cfg)
        self.is_ct = cfg.mode in ("wgan-CT", "wgan-ct")
        self.is_gp = self.is_ct or cfg.mode == "wgan-gp"

    def init_state(self, gen_params: dict, disc_params: dict) -> GanState:
        for p in (*gen_params.values(), *disc_params.values()):
            p.requires_grad_(True)
        return GanState(
            gen_params, disc_params,
            self.gen_optimizer.init(gen_params), self.disc_optimizer.init(disc_params),
        )

    def disc_loss(self, disc_params, gen_params, real, rand, *, create_graph: bool = True):
        cfg = self.cfg
        with torch.no_grad():
            fake = self.gen_fn(gen_params, real.shape[0], rand)
        d_real, f_real = self.disc_fn(disc_params, real, rand)
        d_fake, _ = self.disc_fn(disc_params, fake, rand)
        if cfg.mode in ("dcgan", "lsgan"):
            loss_fn = dcgan_losses if cfg.mode == "dcgan" else lsgan_losses
            _, cost = loss_fn(d_real, d_fake)
            return cost, {"disc_cost": cost}
        _, cost = wgan_losses(d_real, d_fake)
        metrics = {"wgan": cost}
        if self.is_ct:
            d_real_2, f_real_2 = self.disc_fn(disc_params, real, rand)
            ct = consistency_term(d_real, d_real_2, f_real, f_real_2,
                                  lambda_2=cfg.lambda_ct, factor_m=cfg.factor_m)
            cost = cost + ct
            metrics["ct"] = ct
        if self.is_gp:
            gp, _ = gradient_penalty(lambda x: self.disc_fn(disc_params, x, rand)[0], real, fake,
                                     rand.gp_alpha(real.shape[0]), create_graph=create_graph)
            cost = cost + cfg.lambda_gp * gp
            metrics["gp"] = gp
        metrics["disc_cost"] = cost
        return cost, metrics

    def gen_loss(self, gen_params, disc_params, rand):
        cfg = self.cfg
        fake = self.gen_fn(gen_params, cfg.batch_size * cfg.gen_bs_multiple, rand)
        d_fake, _ = self.disc_fn(disc_params, fake, rand)
        if cfg.mode == "dcgan":
            return dcgan_losses(d_fake.new_zeros(1), d_fake)[0]
        if cfg.mode == "lsgan":
            return lsgan_losses(d_fake.new_zeros(1), d_fake)[0]
        return -d_fake.mean()

    def full_params(self, state) -> tuple[dict, dict]:
        """(G's, D's) leaves a substep computes with: the stored ones, or
        under ``spmd_hooks`` the gathered ones."""
        hooks = self.spmd_hooks
        if hooks is None:
            return state.gen_params, state.disc_params
        return hooks.gather_gen(state.gen_params), hooks.gather_disc(state.disc_params)

    def norm_scope(self):
        """The batch-norm group of the hooks around a substep."""
        hooks = self.spmd_hooks
        return batch_group(hooks.batch_group) if hooks is not None else contextlib.nullcontext()

    def gen_substep(self, state: GanState, rand) -> torch.Tensor:
        """G update.  At step 0 the update is computed and dropped, as the
        JAX step blends it away, so both draw the same randomness.  A
        captured step (``train.capture``) runs step 0 eagerly and is
        captured at a later step, so its graph always takes the update."""
        with self.norm_scope():
            gen_params, disc_params = self.full_params(state)
            cost = self.gen_loss(gen_params, disc_params, rand)
            names = list(gen_params)
            grads = dict(zip(names, torch.autograd.grad(cost, [gen_params[k] for k in names])))
        if self.spmd_hooks is not None:
            grads = self.spmd_hooks.sync_gen_grads(grads)
            cost = self.spmd_hooks.sync_metrics(cost.detach())
        if state.step > 0:
            self.gen_optimizer.update(grads, state.gen_opt, state.gen_params, state.step, rand)
        return cost.detach()

    def critic_substep(self, state: GanState, real: torch.Tensor, rand) -> dict:
        """One critic update on a ``[B, D]`` batch of reals in [-1, 1]."""
        cfg = self.cfg
        with self.norm_scope():
            gen_params, disc_params = self.full_params(state)
            cost, metrics = self.disc_loss(disc_params, gen_params, real, rand)
            names = list(disc_params)
            grads = dict(zip(names, torch.autograd.grad(cost, [disc_params[k] for k in names])))
        metrics = {k: v.detach() for k, v in metrics.items()}
        if self.spmd_hooks is not None:
            # the mesh mean (and the shards) before any clip: the clips see the one-device gradients
            grads = self.spmd_hooks.sync_disc_grads(grads)
            metrics = self.spmd_hooks.sync_metrics(metrics)
        if cfg.clip_grad_value is not None:
            grads = clip_grads_by_value(grads, cfg.clip_grad_value)
        if cfg.clip_global_norm is not None:
            grads, metrics["gradnorm"] = clip_grads_by_global_norm(grads, cfg.clip_global_norm)
        self.disc_optimizer.update(grads, state.disc_opt, state.disc_params, state.step, rand)
        if cfg.mode == "wgan":
            clip_params_by_value(state.disc_params, cfg.clip_value)
        return metrics

    def step(self, state: GanState, real_stack: torch.Tensor, rand) -> dict:
        """One iteration on ``real_stack``, ``[K, B, D]`` reals in [-1, 1].
        Returns the last critic substep's metrics plus ``gen_cost`` as 0-d
        device tensors."""
        g_cost = self.gen_substep(state, rand)
        for i in range(real_stack.shape[0]):
            metrics = self.critic_substep(state, real_stack[i], rand)
        metrics["gen_cost"] = g_cost
        state.step += 1
        return metrics

    def dev_cost(self, state: GanState, real: torch.Tensor, rand) -> torch.Tensor:
        """The critic's cost on a dev batch of reals in [-1, 1].  No
        parameter gradient is taken; the gradient penalty takes D's input
        gradient without keeping its graph."""
        detached = lambda p: {k: v.detach() for k, v in p.items()}
        cost, _ = self.disc_loss(detached(state.disc_params), detached(state.gen_params), real, rand,
                                 create_graph=False)
        return cost.detach()

    @torch.no_grad()
    def sample(self, state: GanState, noise: torch.Tensor, rand) -> torch.Tensor:
        """Flat images from given noise."""
        return self.gen_fn(state.gen_params, noise.shape[0], rand, noise=noise)
