"""Semi-supervised GAN-classifier losses (counterpart of
``ctgan_tpu/losses/semisup.py:33-177``).

All take pre-softmax class logits.  The unlabeled objective treats
``log_sum_exp(logits)`` as the "real" score: large on real examples, small
on generated ones; the consistency term (CT) compares two stochastic passes,
or in the temporal-ensembling variant a pass and the bias-corrected EMA
targets.  Every loss is computed in fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.activations import log_sum_exp, softplus

__all__ = [
    "classification_error", "ct_cifar_unlabeled_loss", "ct_mnist_unlabeled_loss", "ct_te_unlabeled_loss",
    "ema_targets_update", "feature_matching_abs", "feature_matching_sq", "labeled_loss",
]


def _f32(*ts: torch.Tensor):
    return [t.float() for t in ts]


def labeled_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``-mean(l_lab) + mean(LSE)``: softmax cross-entropy written as the
    reference writes it."""
    (logits,) = _f32(logits)
    l_lab = logits.gather(1, labels[:, None]).squeeze(1)
    return -l_lab.mean() + log_sum_exp(logits).mean()


def classification_error(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``mean(argmax != label)``."""
    return (logits.argmax(dim=1) != labels).float().mean()


def _softmax_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (torch.softmax(a, dim=1) - torch.softmax(b, dim=1)).square()


def _real_fake_terms(l_unl: torch.Tensor, l_fake: torch.Tensor) -> torch.Tensor:
    return -l_unl.mean() + softplus(l_unl).mean() + softplus(l_fake).mean()


def ct_mnist_unlabeled_loss(logits_unl, logits_unl2, feat_unl, feat_unl2, logits_fake, *,
                            lambda_2: float = 0.1, factor_m: float = 0.0,
                            feature_weight: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """MNIST: a hinged CT on the softmax outputs (the feature term weighted 0
    by default).  Returns ``(loss_unl, ct_mean)``."""
    logits_unl, logits_unl2, feat_unl, feat_unl2, logits_fake = _f32(
        logits_unl, logits_unl2, feat_unl, feat_unl2, logits_fake)
    loss_ct = _softmax_sq(logits_unl, logits_unl2).mean(dim=1)
    loss_ct_feat = (feat_unl - feat_unl2).square().mean(dim=1)
    ct = lambda_2 * (loss_ct + feature_weight * loss_ct_feat) - factor_m
    ct_mean = torch.clamp(ct, min=0.0).mean()
    loss_unl = 0.5 * (ct_mean + _real_fake_terms(log_sum_exp(logits_unl), log_sum_exp(logits_fake)))
    return loss_unl, ct_mean


def ct_cifar_unlabeled_loss(logits_unl, logits_unl2, feat_unl, feat_unl2, logits_fake, *,
                            softmax_weight: float = 0.5, feature_weight: float = 0.05) -> torch.Tensor:
    """CIFAR-10: weighted softmax-MSE and feature-MSE consistency, plus the
    real/fake LSE terms at weight 0.5."""
    logits_unl, logits_unl2, feat_unl, feat_unl2, logits_fake = _f32(
        logits_unl, logits_unl2, feat_unl, feat_unl2, logits_fake)
    loss_comp = _softmax_sq(logits_unl, logits_unl2).mean()
    loss_comp_feat = (feat_unl - feat_unl2).square().mean()
    l_unl, l_fake = log_sum_exp(logits_unl), log_sum_exp(logits_fake)
    return (feature_weight * loss_comp_feat + softmax_weight * loss_comp - 0.5 * l_unl.mean()
            + 0.5 * softplus(l_unl).mean() + 0.5 * softplus(l_fake).mean())


def ct_te_unlabeled_loss(logits_unl, feat_unl, target_probs, target_feats, logits_fake, *,
                         lambda_2: float = 1.0, factor_m: float = 0.0,
                         feature_weight: float = 0.1) -> torch.Tensor:
    """Temporal ensembling: the hinged CT against the EMA targets instead of
    a second pass."""
    logits_unl, feat_unl, logits_fake = _f32(logits_unl, feat_unl, logits_fake)
    loss_ct = (torch.softmax(logits_unl, dim=1) - target_probs).square().mean(dim=1)
    loss_ct_feat = (feat_unl - target_feats).square().mean(dim=1)
    ct = lambda_2 * (loss_ct + feature_weight * loss_ct_feat) - factor_m
    ct_mean = torch.clamp(ct, min=0.0).mean()
    l_unl, l_fake = log_sum_exp(logits_unl), log_sum_exp(logits_fake)
    # the reference's "- log(1)" term is 0 and left out
    return 0.5 * (ct_mean + _real_fake_terms(l_unl, l_fake))


def _batch_mean_gap(feat_fake: torch.Tensor, feat_real: torch.Tensor) -> torch.Tensor:
    return feat_fake.float().mean(dim=0) - feat_real.float().mean(dim=0)


def feature_matching_sq(feat_fake: torch.Tensor, feat_real: torch.Tensor) -> torch.Tensor:
    """G's loss ``mean((E[f(G(z))] - E[f(x)])^2)`` (MNIST, TE)."""
    return _batch_mean_gap(feat_fake, feat_real).square().mean()


def feature_matching_abs(feat_fake: torch.Tensor, feat_real: torch.Tensor) -> torch.Tensor:
    """G's loss, L1 (CIFAR-10)."""
    return _batch_mean_gap(feat_fake, feat_real).abs().mean()


def ema_targets_update(ensemble: torch.Tensor, epoch_predictions: torch.Tensor, epoch_index: int, *,
                       decay: float = 0.6) -> tuple[torch.Tensor, torch.Tensor]:
    """Temporal-ensembling EMA with its start-up bias correction: returns
    ``(new_ensemble, targets)``.  ``epoch_index`` counts the updates since
    the ensemble started (0 for the first)."""
    new_ensemble = decay * ensemble + (1.0 - decay) * epoch_predictions
    correction = np.float32(1.0) - np.float32(decay) ** np.float32(epoch_index + 1)
    return new_ensemble, new_ensemble / float(correction)
