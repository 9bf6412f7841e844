"""What the two semi-supervised apps share (counterpart of the common parts of
``ctgan_tpu/apps/ct_mnist_ssl.py`` and ``ct_cifar_ssl.py``): label
selection, the set-up (parameters, data-dependent init, trainer, data on
the device), one step, the test sweep, and the epoch loop with its
checkpoints and resume.

The data lives on the device; each epoch's orders come from
``np.random.default_rng((seed, epoch))`` as in the JAX apps (the labelled
set tiled in fresh permutations to the unlabelled size, then two
permutations of the unlabelled set), go to the device once, and each of the
``n // batch_size`` steps gathers its batches there.  Step ``s`` draws from
``Randomness(seed).for_step(s)``, so a resumed run draws what an
uninterrupted one does.  On the card each step is one replay of a CUDA graph
(``train.capture.step_runner``).  Metrics stay on the device until the epoch
ends: the step does not synchronise.

The JAX apps' dispatch modes (``ctgan_tpu/apps/ct_cifar_ssl.py:282-330``),
the same steps with the same draws, so the state after an epoch does not
depend on the mode where the same steps ran:

* ``chunk=K`` (default 1): the epoch runs in chunks ``range(0, n_batches,
  K)``; a ragged last chunk is dropped unless it is the first; each logged
  mean is the mean of the chunks' means over the chunks that ran;
* ``epoch_scan``: every batch of the epoch as one range; each logged mean
  is the mean over the steps.

In every mode the step metrics stay on the device and are read once, at
the end of the epoch.

Every epoch: those means and ``test_err`` (the averaged parameters' error
over the test set's ``len // batch_size`` batches) are logged (``log.pkl``,
``log.ndjson``), then ``disc_params.npz``, ``gen_params.npz``,
``avg_params.npz`` and ``ssl_state.npz`` are written in the JAX package's
format.  A run in an ``out_dir`` that holds them resumes from
``ssl_state.npz`` (exactly, TE buffers included), or, with the state gone,
approximately from the three parameter files and ``log.pkl``
(``utils.resume.resolve_ssl_resume``); either package reads what the other
wrote.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..bridge import from_jax_params, state_from_jax, state_to_jax, to_jax_params
from ..core import Randomness, default_policy, split_params
from ..data.augment import random_crop_flip
from ..losses.semisup import ema_targets_update
from ..models.classifiers import with_applied_weights
from ..train import SslConfig, SslState, SslTrainer, data_dependent_init, make_ssl_trainer
from ..train import capture
from ..utils import MetricLogger, StepWatchdog, load_checkpoint, save_checkpoint
from ..utils.resume import reap_stale_tmps, resolve_ssl_resume

__all__ = [
    "SslApp", "TE_FEATURES", "build", "chunks", "epoch_means", "epoch_orders", "make_step_fn", "run",
    "select_labeled", "test_error",
]

TE_FEATURES = 128  # the CIFAR-10 classifier's features, kept per example by temporal ensembling
CROP_PAD = 2
METRICS = {"mnist": ("loss_lab", "loss_unl", "train_err", "loss_ct"),
           "cifar": ("loss_lab", "loss_unl", "train_err", "loss_gen")}


class SslApp(NamedTuple):
    """What a run of a semi-supervised app holds; the tensors lie on the
    run's device."""

    trainer: SslTrainer
    state: SslState
    rand: Randomness       # the run's base provider
    labeled: tuple         # (images, labels) of the labelled set
    train: torch.Tensor    # the unlabelled set: every training image
    test: tuple            # (images, labels)
    augment: bool          # crop and flip each batch (CIFAR-10)


def select_labeled(trainx: np.ndarray, trainy: np.ndarray, count: int, rng: np.random.Generator):
    """The first ``count`` examples of each class after a shuffle
    (``CT_MNIST.py:127-137``)."""
    inds = rng.permutation(len(trainx))
    trainx, trainy = trainx[inds], trainy[inds]
    txs = [trainx[trainy == j][:count] for j in range(10)]
    tys = [trainy[trainy == j][:count] for j in range(10)]
    return np.concatenate(txs), np.concatenate(tys)


def build(cfg, arch: str, classifier_fn: Callable, generator_fn: Callable, init_params: Callable,
          train: tuple, test: tuple, device, *, variant: str, lambda_2: float, augment: bool) -> SslApp:
    """A fresh run of ``cfg`` on ``device``: ``init_params(arch, cfg.seed)``
    through the bridge, the data-dependent init on the first 500 training
    images (its draws from ``Randomness(cfg.seed)``), the trainer, the
    labelled set of ``cfg.count`` per class (``default_rng(cfg.seed_data)``)
    and the data on the device.  Sets the fp32 policy: the JAX apps never set
    bf16."""
    device = torch.device(device)
    default_policy(enable_bf16=False)
    trainx, trainy = train
    txs, tys = select_labeled(trainx, trainy, cfg.count, np.random.default_rng(cfg.seed_data))
    params = {k: v.to(device) for k, v in from_jax_params(init_params(arch, cfg.seed)).items()}
    disc, gen, rest = split_params(params, "Classifier", "Generator")
    if rest:
        raise RuntimeError(f"parameters outside the classifier and G: {sorted(rest)}")
    init_x = torch.from_numpy(trainx[:500]).to(device)
    init_rand = Randomness(cfg.seed, device)
    merged = data_dependent_init({**disc, **gen}, lambda updates: classifier_fn(
        with_applied_weights(disc), init_x, init_rand, init_updates=updates))
    disc = {k: v for k, v in merged.items() if k.startswith("Classifier")}
    trainer = make_ssl_trainer(classifier_fn, generator_fn, SslConfig(
        variant=variant, unlabeled_weight=cfg.unlabeled_weight, lr=cfg.learning_rate, lambda_2=lambda_2,
        factor_m=cfg.factor_M))
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return SslApp(trainer, trainer.init_state(disc, gen), Randomness(cfg.seed, device), (to_dev(txs), to_dev(tys)),
                  to_dev(trainx), (to_dev(test[0]), to_dev(test[1])), augment)


def make_step_fn(app: SslApp):
    """``step_fn(state, lab_idx, unl_idx, unl2_idx, targets, rand)``: the
    step's batches gathered on the device (cropped and flipped first where
    ``app.augment``, the labelled batch, then each unlabelled one), then
    ``trainer.step``, every draw from ``rand.for_step(state.step)`` (``rand``
    is ``app.rand``, or a captured step's provider).  Returns
    ``trainer.step``'s ``(metrics, probs, features)``."""

    def step_fn(state: SslState, lab_idx, unl_idx, unl2_idx, targets, rand):
        rand = rand.for_step(state.step)
        x_lab, x_unl, x_unl2 = app.labeled[0][lab_idx], app.train[unl_idx], app.train[unl2_idx]
        if app.augment:
            x_lab, x_unl, x_unl2 = (random_crop_flip(x, rand.crop_offsets(len(x), CROP_PAD), rand.flip(len(x)),
                                                     pad=CROP_PAD) for x in (x_lab, x_unl, x_unl2))
        return app.trainer.step(state, x_lab, app.labeled[1][lab_idx], x_unl, x_unl2, targets, rand)

    return step_fn


def test_error(app: SslApp, state: SslState, batch_size: int) -> float:
    """The mean of the averaged parameters' error over the test set's
    ``len // batch_size`` batches (deterministic passes)."""
    x, y = app.test
    n_batches = len(x) // batch_size
    total = sum(app.trainer.test_error(state, x[i * batch_size:(i + 1) * batch_size],
                                       y[i * batch_size:(i + 1) * batch_size]) for i in range(n_batches))
    return float(total / n_batches)


def chunks(n_batches: int, chunk: int, epoch_scan: bool = False) -> list[tuple[int, int]]:
    """The ``(t0, t1)`` batch ranges an epoch runs: ``range(0, n_batches,
    chunk)``, a ragged last chunk dropped unless it is the first
    (``ctgan_tpu/apps/ct_cifar_ssl.py:301-304``); ``epoch_scan`` runs every
    batch as one range."""
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, not {chunk}")
    if epoch_scan:
        return [(0, n_batches)] if n_batches else []
    out = []
    for t0 in range(0, n_batches, chunk):
        t1 = min(t0 + chunk, n_batches)
        if t1 - t0 != chunk and t0 > 0:
            break
        out.append((t0, t1))
    return out


def epoch_means(rows: torch.Tensor, ranges: list[tuple[int, int]]) -> list[float]:
    """The logged epoch means of the ``[steps, metrics]`` step metrics
    ``rows``: each range's fp32 mean, then the mean of those in fp64 (with
    ``chunk=1`` the steps' mean)."""
    if not ranges:
        return [0.0] * rows.shape[1]
    per_chunk = torch.stack([rows[t0:t1].mean(0) for t0, t1 in ranges])
    return (per_chunk.double().sum(0) / len(ranges)).tolist()


def epoch_orders(seed: int, epoch: int, n: int, n_labeled: int):
    """The JAX apps' orders of ``epoch``: the tiled labelled indices and two
    permutations of the unlabelled set."""
    erng = np.random.default_rng((seed, epoch))
    reps = int(np.ceil(n / n_labeled))
    lab_idx = np.concatenate([erng.permutation(n_labeled) for _ in range(reps)])[:n]
    return lab_idx, erng.permutation(n), erng.permutation(n)


class _Ensemble(NamedTuple):
    """Temporal ensembling's per-example buffers (``CT_CIFAR-10_TE.py:177-180``)."""

    ensemble: torch.Tensor
    ensemble2: torch.Tensor
    targets: torch.Tensor
    targets2: torch.Tensor


def _zero_ensemble(n: int, device) -> _Ensemble:
    z = lambda width: torch.zeros(n, width, device=device)
    return _Ensemble(z(10), z(TE_FEATURES), z(10), z(TE_FEATURES))


def _load_params(path: str, device, requires_grad: bool = False) -> dict:
    return {k: v.to(device).requires_grad_(requires_grad) for k, v in from_jax_params(load_checkpoint(path)).items()}


def run(cfg, app: SslApp, out_dir: str, device, *, name: str, ensemble: bool = False,
        temporal_ensembling: bool = False, prediction_decay: float = 0.6):
    """Train to ``cfg.epochs`` epochs from ``app``'s fresh state, or from
    what ``out_dir`` holds; returns the final state and the records this
    process logged.  With ``ensemble`` (the CIFAR-10 app, as the JAX app
    does) the temporal-ensembling buffers are kept, saved and resumed; they
    are updated only with ``temporal_ensembling``.  ``cfg.chunk`` and
    ``cfg.epoch_scan`` (where the config has them) choose the dispatch
    mode."""
    device = torch.device(device)
    chunk, epoch_scan = getattr(cfg, "chunk", 1), getattr(cfg, "epoch_scan", False)
    state, trainer, bs = app.state, app.trainer, cfg.batch_size
    n, n_labeled = len(app.train), len(app.labeled[0])
    metric_names = METRICS["mnist" if trainer.cfg.variant == "mnist" else "cifar"]
    logger = MetricLogger(out_dir)
    reap_stale_tmps(out_dir)
    ckpt_path = f"{out_dir}/ssl_state.npz"
    mode, start_epoch, blob = resolve_ssl_resume(out_dir, ckpt_path, allow_fresh_start=cfg.allow_fresh_start)
    ens = _zero_ensemble(n, device) if ensemble else None
    ens_base = 0  # the epoch the ensemble started from: its bias correction counts from here
    if mode == "exact":
        state = state_from_jax(blob["state"], device, SslState)
        if ensemble:
            ens = _Ensemble(*(torch.from_numpy(np.asarray(blob[k], np.float32)).to(device) for k in _Ensemble._fields))
            ens_base = int(blob.get("ens_base", 0))
        print(f"resumed from {ckpt_path} at epoch {start_epoch}")
    elif mode == "approx":
        disc_path, gen_path = blob
        state = trainer.init_state(_load_params(disc_path, device), _load_params(gen_path, device))
        avg_path = f"{out_dir}/avg_params.npz"
        # without a tracked average, start it at the params: the zero start
        # would need about 2 / ema_rate steps to recover
        state.avg_params = (_load_params(avg_path, device) if os.path.exists(avg_path)
                            else {k: v.detach().clone() for k, v in state.disc_params.items()})
        ens_base = start_epoch
        print(f"resumed (approximate) from {disc_path} + log.pkl at epoch {start_epoch}: params exact, "
              "optimizer/EMA re-warmed")
    logger.set_iteration(start_epoch)

    step_fn = make_step_fn(app)
    step = capture.step_runner(step_fn, app.rand, name=name)
    ranges = chunks(n // bs, chunk, epoch_scan)
    watchdog = StepWatchdog.start_from_env(name=name)
    try:
        for epoch in range(start_epoch, cfg.epochs):
            orders = [torch.from_numpy(o).to(device) for o in epoch_orders(cfg.seed, epoch, n, n_labeled)]
            rows = []
            if temporal_ensembling:
                preds, preds2 = torch.zeros_like(ens.ensemble), torch.zeros_like(ens.ensemble2)
            for b in range(ranges[-1][1] if ranges else 0):
                lab_idx, unl_idx, unl2_idx = (o[b * bs:(b + 1) * bs] for o in orders)
                targets = (ens.targets[unl_idx], ens.targets2[unl_idx]) if temporal_ensembling else None
                metrics, probs, feats = step(state, lab_idx, unl_idx, unl2_idx, targets)
                rows.append(torch.stack([metrics[k] for k in metric_names]))
                if temporal_ensembling:
                    preds[unl_idx], preds2[unl_idx] = probs, feats
            if temporal_ensembling:
                (e1, t1), (e2, t2) = (ema_targets_update(e, p, epoch - ens_base, decay=prediction_decay)
                                      for e, p in ((ens.ensemble, preds), (ens.ensemble2, preds2)))
                ens = _Ensemble(e1, e2, t1, t2)
            means = epoch_means(torch.stack(rows) if rows else torch.zeros(0, len(metric_names)), ranges)
            test_err = test_error(app, state, bs)
            for k, v in zip(metric_names, means):
                logger.plot(k, v)
            logger.plot("test_err", test_err)
            logger.tick()
            logger.flush()
            for field in ("disc_params", "gen_params", "avg_params"):
                save_checkpoint(f"{out_dir}/{field}.npz", to_jax_params(getattr(state, field)))
            blob = {"state": state_to_jax(state), "epoch": epoch}
            if ensemble:
                blob.update(ens._asdict(), ens_base=ens_base)
            save_checkpoint(ckpt_path, blob)
            watchdog.beat()
    finally:
        watchdog.stop()
    return state, logger.records
