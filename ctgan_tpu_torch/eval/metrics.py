"""Sample-quality metrics: Inception Score and FID (own copy of
``ctgan_tpu/eval/metrics.py``; NumPy only).

``inception_score_from_probs`` splits the class-probability matrix into
``splits`` parts, computes exp(mean(KL(p(y|x) || p(y)))) per part, and
returns the mean and standard deviation over the parts.  ``fid_from_features``
is the Frechet distance between Gaussians fitted to two feature sets.
"""

from __future__ import annotations

import numpy as np

__all__ = ["inception_score_from_probs", "fid_from_features"]


def inception_score_from_probs(probs: np.ndarray, splits: int = 10) -> tuple[float, float]:
    probs = np.asarray(probs, dtype=np.float64)
    n = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * n // splits : (i + 1) * n // splits]
        if len(part) == 0:
            continue
        kl = part * (np.log(part + 1e-12) - np.log(np.mean(part, axis=0, keepdims=True) + 1e-12))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores)), float(np.std(scores))


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a (near-)PSD symmetric matrix via eigh."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def fid_from_features(feat_real: np.ndarray, feat_fake: np.ndarray) -> float:
    """Fréchet distance ‖μ1−μ2‖² + Tr(Σ1 + Σ2 − 2(Σ1Σ2)^{1/2})."""
    f1 = np.asarray(feat_real, np.float64)
    f2 = np.asarray(feat_fake, np.float64)
    mu1, mu2 = f1.mean(axis=0), f2.mean(axis=0)
    s1 = np.cov(f1, rowvar=False)
    s2 = np.cov(f2, rowvar=False)
    diff = mu1 - mu2
    # sqrtm(S1 @ S2) via the PSD trick: sqrtm(S1) S2 sqrtm(S1) is symmetric PSD
    rs1 = _sqrtm_psd(s1)
    covmean = _sqrtm_psd(rs1 @ s2 @ rs1)
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * np.trace(covmean))
