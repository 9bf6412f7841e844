"""Trained-classifier scorer, the self-contained Inception Score (counterpart
of ``ctgan_tpu/eval/scorer.py:33-163``).

A small classifier is trained once on the real training set and cached;
the inception score is the exp-KL of its softmax over generated images,
and FID uses its pooled features.  Scores are comparable between
checkpoints scored by the same cached classifier, not with the
Inception-2015 network's.

The parameters keep the JAX package's names (``Scorer.C1.Filters`` ...)
and, in the cache file, its layouts, so the port reads a ``scorer.npz``
the JAX package wrote and the other way round.  In memory they are
port-layout tensors on the scorer's device.  :meth:`TrainedScorer.fit`
trains as the JAX one does: TF-Adam at lr 1e-3, betas 0.9 and 0.999, and
batches in the order of ``np.random.default_rng(seed)``'s permutations.

Its convs and its linear layer run under the precision policy, so under the
flagship app's bf16 default on the card the scorer fits and scores in bf16,
as the JAX package's global policy makes it on the TPU; probabilities and
features leave the device as fp32.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..bridge import from_jax_params, to_jax_params
from ..core.store import ParamInit
from ..models.common import flat_to_nchw
from ..ops import batchnorm, conv2d, global_mean_pool, linear
from ..train.optim import Adam
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from .metrics import fid_from_features, inception_score_from_probs

__all__ = ["init_scorer_params", "scorer_net", "TrainedScorer"]

N_CLASSES = 10


def init_scorer_params(channels: int, dim: int = 64, seed: int = 0) -> dict[str, np.ndarray]:
    """Fresh parameters in the JAX layout, drawn in the order in which the
    JAX ``scorer_net`` creates them under ``init_context(seed)``."""
    init = ParamInit(seed)
    init.conv("Scorer.C1", channels, dim, 3, stride=2)
    init.conv("Scorer.C2", dim, 2 * dim, 3, stride=2)
    init.norm("Scorer.BN1", 2 * dim)
    init.conv("Scorer.C3", 2 * dim, 4 * dim, 3, stride=2)
    init.norm("Scorer.BN2", 4 * dim)
    init.linear("Scorer.Out", 4 * dim, N_CLASSES)
    return init.params


def scorer_net(p: dict, x_flat: torch.Tensor, channels: int, size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Three stride-2 SAME convs (the last two batch-normed with the
    batch's statistics), a global mean pool and a linear layer.  Returns
    ``(logits [N, 10], features [N, 4 * dim])``."""
    out = flat_to_nchw(x_flat, channels, size, size)
    out = torch.relu(conv2d(out, p["Scorer.C1.Filters"], p["Scorer.C1.Biases"], stride=2))
    out = conv2d(out, p["Scorer.C2.Filters"], p["Scorer.C2.Biases"], stride=2)
    out = torch.relu(batchnorm(out, p["Scorer.BN1.scale"], p["Scorer.BN1.offset"]))
    out = conv2d(out, p["Scorer.C3.Filters"], p["Scorer.C3.Biases"], stride=2)
    out = torch.relu(batchnorm(out, p["Scorer.BN2.scale"], p["Scorer.BN2.offset"]))
    feats = global_mean_pool(out)
    return linear(feats, p["Scorer.Out.W"], p["Scorer.Out.b"]), feats


def _as_tensor(images, device) -> torch.Tensor:
    """Images as a tensor on ``device``, in their own dtype."""
    if isinstance(images, torch.Tensor):
        return images.to(device)
    return torch.from_numpy(np.ascontiguousarray(images)).to(device)


class TrainedScorer:
    """Train-once-and-cache classifier scorer on ``device``.

    Images are flat ``[N, C*H*W]``, uint8-valued (scaled to [-1, 1]) or
    already in [-1, 1]; NumPy arrays or tensors.  ``comparable`` is False:
    its scores are not the Inception-2015 network's."""

    comparable = False

    def __init__(self, channels: int, size: int, dim: int = 64, cache_path: str | None = None,
                 device="cuda"):
        self.channels, self.size, self.dim = channels, size, dim
        self.cache_path = cache_path
        self.device = torch.device(device)
        self.params: dict[str, torch.Tensor] | None = None
        if cache_path and os.path.exists(cache_path):
            self.params = self._to_device(load_checkpoint(cache_path))

    def _to_device(self, jax_params: dict) -> dict[str, torch.Tensor]:
        return {k: v.to(self.device) for k, v in from_jax_params(jax_params).items()}

    @staticmethod
    def _normalize(x: torch.Tensor, from_255: bool) -> torch.Tensor:
        x = x.float()
        return 2.0 * (x / 255.0 - 0.5) if from_255 else x

    def fit(self, images, labels, *, epochs: int = 3, batch_size: int = 128, lr: float = 1e-3,
            seed: int = 0, verbose: bool = False) -> float:
        """Train from fresh parameters; returns the last batch's accuracy.
        Caches the weights when done."""
        x = _as_tensor(images, self.device)
        y = _as_tensor(np.asarray(labels, "int64"), self.device)
        from_255 = float(x.max()) > 1.5
        params = self._to_device(init_scorer_params(self.channels, self.dim, seed))
        for v in params.values():
            v.requires_grad_(True)
        names = list(params)
        opt = Adam(lr)
        opt_state = opt.init(params)
        rng = np.random.default_rng(seed)
        acc = torch.zeros(())
        for epoch in range(epochs):
            perm = torch.from_numpy(rng.permutation(len(x))).to(self.device)
            for i in range(0, len(x) - batch_size + 1, batch_size):
                idx = perm[i : i + batch_size]
                logits, _ = scorer_net(params, self._normalize(x[idx], from_255), self.channels,
                                       self.size)
                ce = F.cross_entropy(logits, y[idx])
                grads = torch.autograd.grad(ce, [params[k] for k in names])
                opt.update(dict(zip(names, grads)), opt_state, params, 0)
                acc = (logits.detach().argmax(1) == y[idx]).float().mean()
            if verbose:
                print(f"scorer epoch {epoch}: acc={float(acc):.3f}")
        self.params = {k: v.detach() for k, v in params.items()}
        if self.cache_path:
            save_checkpoint(self.cache_path, to_jax_params(self.params))
        return float(acc)

    @torch.no_grad()
    def _apply(self, images, batch_size: int = 2500) -> tuple[np.ndarray, np.ndarray]:
        """(softmax probabilities, features), in batches of ``batch_size``."""
        if self.params is None:
            raise RuntimeError("call fit() first or provide a cache")
        x = _as_tensor(images, self.device)
        from_255 = float(x.max()) > 1.5
        probs, feats = [], []
        for i in range(0, len(x), batch_size):
            logits, f = scorer_net(self.params, self._normalize(x[i : i + batch_size], from_255),
                                   self.channels, self.size)
            probs.append(torch.softmax(logits, dim=1))
            feats.append(f)
        return torch.cat(probs).float().cpu().numpy(), torch.cat(feats).float().cpu().numpy()

    def probs(self, images) -> np.ndarray:
        return self._apply(images)[0]

    def features(self, images) -> np.ndarray:
        return self._apply(images)[1]

    def inception_score(self, images, splits: int = 10) -> tuple[float, float]:
        """10-split exp-KL mean and standard deviation."""
        return inception_score_from_probs(self.probs(images), splits)

    def fid(self, real_images, fake_images) -> float:
        return fid_from_features(self.features(real_images), self.features(fake_images))

    def sanity_check(self, test_images, test_labels) -> float:
        """Accuracy on a labelled real set."""
        probs = self.probs(test_images)
        return float(np.mean(np.argmax(probs, 1) == np.asarray(test_labels)))
