"""Conditional ACGAN CT-GAN trainer (counterpart of
``ctgan_tpu/train/trainer_acgan.py``).

One iteration is one generator update, skipped at step 0 as in the
reference (``if iteration > 0``), then ``critic_iters`` critic updates.
Each critic update dequantises a uint8 batch with U[0, 1/128) noise, runs
real and fake through D twice with independent dropout (as one 4B-row pass
when ``fuse_ct_passes``), adds the consistency term, the gradient penalty
(a double backward) and the ACGAN cross-entropy, and takes a TF-Adam step
with linear LR decay.  A ``clean_pass`` at keep probability 1 gives the
accuracy monitors.

Every random draw comes from the ``rand`` argument
(:class:`ctgan_tpu_torch.core.rng.Randomness` or a test's injected draws),
and so do the optimisers' per-step scalars (``optim.device_scalars``).
The state is updated in place.

:meth:`AcganTrainer.dev_cost`, :meth:`~AcganTrainer.sample` and
:meth:`~AcganTrainer.generate` are the evaluation functions
(``ctgan_tpu/train/trainer_acgan.py:275-305``).  Batch norm in G uses the
statistics of the batch it is given, so samples depend on the batch size.

``remat`` recomputes each differentiated D pass (the CT pair, the GP's
interpolates, G's pass) in the backward, and ``opt_state_dtype`` stores
the Adam moments in that dtype, as in ``train.trainer_gan``
(``ctgan_tpu/train/trainer_acgan.py:100-107``).  A recomputed pass replays
its draws with the rows' blocks it was drawn with (the fused CT pass: 4).

``spmd_hooks`` (``parallel.SpmdHooks``) run the substeps over a mesh of
processes at the JAX trainer's hook points
(``ctgan_tpu/train/trainer_acgan.py:194-240``), as in
``train.trainer_gan``.  Each D pass declares its global layout to the
provider (``core.rng.pass_rows``): the fused CT pass is four blocks (real,
fake, real, fake), an unfused CT pass two, so that a rank's masks are its
rows of the one-process masks (the clean pass draws none).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..core.rng import pass_rows
from ..losses.gan import (
    acgan_accuracy,
    acgan_loss,
    consistency_term,
    gradient_penalty,
    wgan_losses,
)
from .optim import Adam, with_state_dtype
from .remat import make_remat_disc
from .schedules import linear_decay
from .trainer_gan import GanTrainer

__all__ = ["AcganConfig", "AcganState", "AcganTrainer"]


@dataclass(frozen=True)
class AcganConfig:
    batch_size: int = 64
    critic_iters: int = 5
    lambda_gp: float = 10.0
    lambda_ct: float = 2.0
    factor_m: float = 0.0
    lr: float = 2e-4
    beta1: float = 0.0
    beta2: float = 0.9
    iters: int = 100000
    decay: bool = True
    gen_bs_multiple: int = 2
    n_labels: int = 10
    conditional: bool = True
    acgan: bool = True
    acgan_scale: float = 1.0
    acgan_scale_g: float = 0.1
    kp: tuple = (0.8, 0.5, 0.5)
    remat: bool = False
    # one 2x-batch D pass for the CT pair; equal to two passes only because
    # this D has no batch-coupled norm (ctgan_tpu/train/trainer_acgan.py:62-65)
    fuse_ct_passes: bool = True
    opt_state_dtype: str = "float32"
    clean_pass: bool = True


@dataclass
class AcganState:
    gen_params: dict
    disc_params: dict
    gen_opt: dict
    disc_opt: dict
    step: int = 0


class AcganTrainer:
    """``gen_fn(params, n, labels, rand, noise=None)`` -> flat images;
    ``disc_fn(params, x, labels, kps, rand)`` -> ``DiscOut``."""

    full_params = GanTrainer.full_params
    norm_scope = GanTrainer.norm_scope

    def __init__(self, gen_fn: Callable, disc_fn: Callable, cfg: AcganConfig, spmd_hooks=None):
        if cfg.remat:
            disc_fn = make_remat_disc(disc_fn)
        self.gen_fn, self.disc_fn, self.cfg, self.spmd_hooks = gen_fn, disc_fn, cfg, spmd_hooks
        lr = linear_decay(cfg.lr, cfg.iters) if cfg.decay else cfg.lr
        self.gen_optimizer = with_state_dtype(Adam(lr, cfg.beta1, cfg.beta2), cfg.opt_state_dtype)
        self.disc_optimizer = with_state_dtype(Adam(lr, cfg.beta1, cfg.beta2), cfg.opt_state_dtype)

    def init_state(self, gen_params: dict, disc_params: dict) -> AcganState:
        for p in (*gen_params.values(), *disc_params.values()):
            p.requires_grad_(True)
        return AcganState(
            gen_params, disc_params,
            self.gen_optimizer.init(gen_params), self.disc_optimizer.init(disc_params),
        )

    def disc_loss(self, disc_params, gen_params, real, labels, rand, *, create_graph: bool = True):
        cfg = self.cfg
        b = real.shape[0]
        with torch.no_grad():
            fake = self.gen_fn(gen_params, b, labels, rand)
        both = torch.cat([real, fake])
        both_labels = torch.cat([labels, labels])
        if cfg.fuse_ct_passes:
            with pass_rows(rand, 4):
                d_pair = self.disc_fn(disc_params, torch.cat([both, both]),
                                      torch.cat([both_labels, both_labels]), cfg.kp, rand)
            d_all = type(d_pair)(*(None if v is None else v[: 2 * b] for v in d_pair))
            d_all_2 = type(d_pair)(*(None if v is None else v[2 * b:] for v in d_pair))
        else:
            with pass_rows(rand, 2):
                d_all = self.disc_fn(disc_params, both, both_labels, cfg.kp, rand)
                d_all_2 = self.disc_fn(disc_params, both, both_labels, cfg.kp, rand)

        d_real, d_fake = d_all.wgan[:b], d_all.wgan[b:]
        _, wgan = wgan_losses(d_real, d_fake)
        ct = consistency_term(
            d_real, d_all_2.wgan[:b], d_all.features[:b], d_all_2.features[:b],
            lambda_2=cfg.lambda_ct, factor_m=cfg.factor_m,
        )
        gp, _ = gradient_penalty(
            lambda x: self.disc_fn(disc_params, x, labels, cfg.kp, rand).wgan,
            real, fake, rand.gp_alpha(b), create_graph=create_graph,
        )
        cost = wgan + ct + cfg.lambda_gp * gp
        metrics = {"wgan": wgan, "ct": ct, "gp": gp}
        if cfg.conditional and cfg.acgan:
            ac = acgan_loss(d_all.acgan[:b], labels)
            cost = cost + cfg.acgan_scale * ac
            metrics["acgan"] = ac
            if cfg.clean_pass:
                with torch.no_grad():  # keep probability 1: draws nothing
                    d_clean = self.disc_fn(disc_params, both, both_labels, (1.0, 1.0, 1.0), rand)
                metrics["acc_real"] = acgan_accuracy(d_clean.acgan[:b], labels)
                metrics["acc_fake"] = acgan_accuracy(d_clean.acgan[b:], labels)
        metrics["disc_cost"] = cost
        return cost, metrics

    def gen_loss(self, gen_params, disc_params, rand):
        cfg = self.cfg
        n = cfg.gen_bs_multiple * cfg.batch_size
        fake_labels = rand.labels(n, cfg.n_labels)
        fake = self.gen_fn(gen_params, n, fake_labels, rand)
        d = self.disc_fn(disc_params, fake, fake_labels, cfg.kp, rand)
        cost = -d.wgan.mean()
        if cfg.conditional and cfg.acgan:
            cost = cost + cfg.acgan_scale_g * acgan_loss(d.acgan, fake_labels)
        return cost

    def gen_substep(self, state: AcganState, rand) -> torch.Tensor:
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

    @staticmethod
    def dequantize(real_u8: torch.Tensor, rand) -> torch.Tensor:
        """uint8-valued pixels -> [-1, 1) plus U[0, 1/128) noise."""
        real = 2.0 * (real_u8.float() / 256.0 - 0.5)
        return real + rand.dequant(real.shape)

    def critic_substep(self, state: AcganState, real_u8: torch.Tensor, labels: torch.Tensor,
                       rand) -> dict:
        real = self.dequantize(real_u8, rand)
        with self.norm_scope():
            gen_params, disc_params = self.full_params(state)
            cost, metrics = self.disc_loss(disc_params, gen_params, real, labels, rand)
            names = list(disc_params)
            grads = dict(zip(names, torch.autograd.grad(cost, [disc_params[k] for k in names])))
        metrics = {k: v.detach() for k, v in metrics.items()}
        if self.spmd_hooks is not None:
            grads = self.spmd_hooks.sync_disc_grads(grads)
            metrics = self.spmd_hooks.sync_metrics(metrics)
        self.disc_optimizer.update(grads, state.disc_opt, state.disc_params, state.step, rand)
        return metrics

    def step(self, state: AcganState, real_stack: torch.Tensor, label_stack: torch.Tensor,
             rand) -> dict:
        """One iteration.  ``real_stack``: ``[K, B, 3072]`` uint8 pixels,
        ``label_stack``: ``[K, B]``.  Returns the last critic substep's
        metrics plus ``gen_cost`` as 0-d device tensors."""
        g_cost = self.gen_substep(state, rand)
        for i in range(real_stack.shape[0]):
            metrics = self.critic_substep(state, real_stack[i], label_stack[i], rand)
        metrics["gen_cost"] = g_cost
        state.step += 1
        return metrics

    def dev_cost(self, state: AcganState, real_u8: torch.Tensor, labels: torch.Tensor,
                 rand) -> torch.Tensor:
        """The critic's cost on a dev batch of uint8-valued pixels,
        dequantised as in training.  No parameter gradient is taken; the
        gradient penalty takes D's input gradient without keeping its graph,
        so no double-backward graph is built."""
        real = self.dequantize(real_u8, rand)
        detached = lambda p: {k: v.detach() for k, v in p.items()}
        cost, _ = self.disc_loss(detached(state.disc_params), detached(state.gen_params),
                                 real, labels, rand, create_graph=False)
        return cost.detach()

    @torch.no_grad()
    def sample(self, state: AcganState, noise: torch.Tensor, labels: torch.Tensor,
               rand) -> torch.Tensor:
        """Flat images from given noise and labels."""
        return self.gen_fn(state.gen_params, noise.shape[0], labels, rand, noise=noise)

    @torch.no_grad()
    def generate(self, state: AcganState, n: int, rand) -> tuple[torch.Tensor, torch.Tensor]:
        """``n`` flat images of uniformly drawn labels, and the labels."""
        labels = rand.labels(n, self.cfg.n_labels)
        return self.gen_fn(state.gen_params, n, labels, rand), labels
