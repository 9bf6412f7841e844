"""Evaluation: inception score and FID (counterpart of ``ctgan_tpu/eval``).

Two scorers:

* :class:`Inception2015`: the reference's frozen-graph protocol, from a
  user-supplied weight file; its scores are comparable with the
  reference's published inception scores.
* :class:`TrainedScorer`: a classifier trained on the real training set and
  cached; always available, and not comparable with Inception-2015 scores.
"""

from .inception2015 import Inception2015, find_inception_file
from .metrics import fid_from_features, inception_score_from_probs
from .scorer import TrainedScorer, init_scorer_params, scorer_net

__all__ = [
    "Inception2015", "TrainedScorer", "fid_from_features", "find_inception_file", "inception_score_from_probs",
    "init_scorer_params", "scorer_net",
]
