"""Semi-supervised GAN-classifier trainer (counterpart of
``ctgan_tpu/train/trainer_semisup.py:38-205``; ``CT_MNIST.py:100-180``,
``CT_CIFAR.py:139-313`` and ``CT_CIFAR-10_TE.py`` of the reference).

One step is the classifier's (D's) update on a labelled batch and an
unlabelled batch, then the exponential average of D's parameters used at
test time (``a += ema_rate * (p - a)``, from zeros), then G's update against
the updated D on a second unlabelled batch.  Both optimisers are
:class:`~ctgan_tpu_torch.train.optim.AdamTheano`.

* D's loss: the labelled cross-entropy plus ``unlabeled_weight`` times the
  variant's unlabelled loss.  D passes over the labelled batch, the
  unlabelled batch and G's samples (G runs without a gradient), and for
  ``mnist`` and ``cifar`` a second pass over the unlabelled batch for the
  consistency term: four passes; ``te`` compares the one pass with the
  ensemble's targets instead: three.
* G's loss: feature matching (squared for ``mnist`` and ``te``, absolute
  for ``cifar``) between D's features of G's samples and of the second
  unlabelled batch.  No gradient of D's weights is taken, and the real
  pass is a constant.

``classifier_fn(params, x, rand, deterministic=False)`` returns a
``ClassifierOut``; ``generator_fn(params, n, rand)`` returns flat images.
Each loss hands its classifier passes D's params with every weight-normed
layer's applied weight computed once
(``models.classifiers.with_applied_weights``); the passes share it.
Every draw comes from ``rand`` (a ``core.rng.Randomness`` or a test's
injected draws) in the JAX trainer's order, and so do the optimisers'
per-step scalars (``t`` advances on the host, ``optim.device_scalars``).
The state is updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..losses.semisup import (
    classification_error,
    ct_cifar_unlabeled_loss,
    ct_mnist_unlabeled_loss,
    ct_te_unlabeled_loss,
    feature_matching_abs,
    feature_matching_sq,
    labeled_loss,
)
from ..models.classifiers import with_applied_weights
from .optim import AdamTheano

__all__ = ["SslConfig", "SslState", "SslTrainer", "make_ssl_trainer"]

VARIANTS = ("mnist", "cifar", "te")


@dataclass(frozen=True)
class SslConfig:
    variant: str = "mnist"          # "mnist" | "cifar" | "te"
    unlabeled_weight: float = 1.0
    lr: float = 0.003               # MNIST's; CIFAR-10's 3e-4
    lambda_2: float = 0.1           # MNIST's CT weight; TE's 1.0
    factor_m: float = 0.0
    ema_rate: float = 1e-4
    mom1: float = 0.5


@dataclass
class SslState:
    """The fields of the JAX package's ``SslState``, in its order."""

    disc_params: dict
    gen_params: dict
    disc_opt: dict
    gen_opt: dict
    avg_params: dict  # the exponential average of D's params, for test
    step: int = 0


def _detached(params: dict) -> dict:
    return {k: v.detach() for k, v in params.items()}


class SslTrainer:
    def __init__(self, classifier_fn: Callable, generator_fn: Callable, cfg: SslConfig):
        if cfg.variant not in VARIANTS:
            raise ValueError(f"unknown variant {cfg.variant!r}")
        self.classifier_fn, self.generator_fn, self.cfg = classifier_fn, generator_fn, cfg
        self.disc_optimizer = AdamTheano(cfg.lr, cfg.mom1)
        self.gen_optimizer = AdamTheano(cfg.lr, cfg.mom1)

    def init_state(self, disc_params: dict, gen_params: dict) -> SslState:
        for p in (*disc_params.values(), *gen_params.values()):
            p.requires_grad_(True)
        return SslState(
            disc_params, gen_params,
            self.disc_optimizer.init(disc_params), self.gen_optimizer.init(gen_params),
            {k: torch.zeros_like(v, requires_grad=False) for k, v in disc_params.items()},
        )

    def disc_loss(self, disc_params, gen_params, x_lab, labels, x_unl, targets, rand):
        """``(cost, metrics, softmax of the unlabelled pass, its features)``;
        ``targets`` is ``(probs, features)`` for ``te``, else None."""
        cfg, classify = self.cfg, self.classifier_fn
        gen_params, disc_params = _detached(gen_params), with_applied_weights(disc_params)
        out_lab = classify(disc_params, x_lab, rand)
        out_unl = classify(disc_params, x_unl, rand)
        with torch.no_grad():
            fake = self.generator_fn(gen_params, x_unl.shape[0], rand)
        out_fake = classify(disc_params, fake, rand)
        l_lab = labeled_loss(out_lab.logits, labels)
        ct = torch.zeros((), device=l_lab.device)
        if cfg.variant == "mnist":
            out_unl2 = classify(disc_params, x_unl, rand)
            l_unl, ct = ct_mnist_unlabeled_loss(
                out_unl.logits, out_unl2.logits, out_unl.features, out_unl2.features, out_fake.logits,
                lambda_2=cfg.lambda_2, factor_m=cfg.factor_m)
        elif cfg.variant == "cifar":
            out_unl2 = classify(disc_params, x_unl, rand)
            l_unl = ct_cifar_unlabeled_loss(
                out_unl.logits, out_unl2.logits, out_unl.features, out_unl2.features, out_fake.logits)
        else:
            target_probs, target_feats = targets
            l_unl = ct_te_unlabeled_loss(out_unl.logits, out_unl.features, target_probs, target_feats,
                                         out_fake.logits, lambda_2=cfg.lambda_2, factor_m=cfg.factor_m)
        cost = l_lab + cfg.unlabeled_weight * l_unl
        metrics = {"loss_lab": l_lab, "loss_unl": l_unl,
                   "train_err": classification_error(out_lab.logits, labels), "loss_ct": ct}
        return cost, metrics, torch.softmax(out_unl.logits.detach(), dim=1), out_unl.features.detach()

    def gen_loss(self, gen_params, disc_params, x_unl, rand) -> torch.Tensor:
        """Feature matching against D's (constant) features of ``x_unl``."""
        with torch.no_grad():
            disc_params = with_applied_weights(_detached(disc_params))
        fake = self.generator_fn(gen_params, x_unl.shape[0], rand)
        out_fake = self.classifier_fn(disc_params, fake, rand)
        with torch.no_grad():
            out_real = self.classifier_fn(disc_params, x_unl, rand)
        match = feature_matching_abs if self.cfg.variant == "cifar" else feature_matching_sq
        return match(out_fake.fm_features, out_real.fm_features)

    def step(self, state: SslState, x_lab, labels, x_unl, x_unl2, targets, rand):
        """One step: D's update, the average, G's update.  ``x_unl`` and
        ``x_unl2`` are the two unlabelled streams (D trains on the first, G
        on the second).  Returns ``(metrics, probs, features)``: 0-d device
        tensors (``loss_lab``, ``loss_unl``, ``train_err``, ``loss_ct``,
        ``loss_gen``) and D's softmax and features of ``x_unl``, the
        temporal ensemble's inputs."""
        cfg = self.cfg
        cost, metrics, probs, feats = self.disc_loss(state.disc_params, state.gen_params, x_lab, labels,
                                                     x_unl, targets, rand)
        names = list(state.disc_params)
        grads = torch.autograd.grad(cost, [state.disc_params[k] for k in names])
        self.disc_optimizer.update(dict(zip(names, grads)), state.disc_opt, state.disc_params, state.step, rand)
        with torch.no_grad():
            avgs = [state.avg_params[k] for k in names]
            torch._foreach_add_(avgs, torch._foreach_sub([state.disc_params[k] for k in names], avgs),
                                alpha=cfg.ema_rate)
        g_cost = self.gen_loss(state.gen_params, state.disc_params, x_unl2, rand)
        names = list(state.gen_params)
        grads = torch.autograd.grad(g_cost, [state.gen_params[k] for k in names])
        self.gen_optimizer.update(dict(zip(names, grads)), state.gen_opt, state.gen_params, state.step, rand)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss_gen"] = g_cost.detach()
        return metrics, probs, feats

    @torch.no_grad()
    def test_error(self, state: SslState, x, labels) -> torch.Tensor:
        """The error of the averaged params on one batch, a deterministic
        pass (a 0-d device tensor)."""
        out = self.classifier_fn(with_applied_weights(state.avg_params), x, None, deterministic=True)
        return classification_error(out.logits, labels)


def make_ssl_trainer(classifier_fn: Callable, generator_fn: Callable, cfg: SslConfig) -> SslTrainer:
    """The trainer of ``cfg.variant`` (``SslTrainer.init_state``, ``.step``
    and ``.test_error`` are the JAX package's ``init_state``, ``step_fn``
    and ``test_fn``)."""
    return SslTrainer(classifier_fn, generator_fn, cfg)
