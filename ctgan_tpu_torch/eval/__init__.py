"""Evaluation: inception score and FID through the trained-classifier
scorer (counterpart of ``ctgan_tpu/eval``).  The Inception-2015 scorer is
not ported: it needs a weight file the repository does not hold."""

from .metrics import fid_from_features, inception_score_from_probs
from .scorer import TrainedScorer, init_scorer_params, scorer_net

__all__ = [
    "TrainedScorer", "fid_from_features", "inception_score_from_probs", "init_scorer_params",
    "scorer_net",
]
