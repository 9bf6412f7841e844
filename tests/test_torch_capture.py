"""The captured step on the CPU (``train.capture.CapturedStep`` with
``graph=False``: what a CUDA graph records, driven eagerly through the
static buffers), its static provider, the optimisers' per-step scalars, and
the semi-supervised apps' dispatch modes.

* ``StaticRandomness``'s buffers hold what ``Randomness(seed).for_step(s)``
  draws, bit for bit, for each app's sequence of draws at steps 0, 1 and
  781, its seed table included.
* The optimisers' fp32 scalars equal the JAX package's ``lr_t`` and
  corrections bit for bit.
* The capturable step equals today's eager step bit for bit over four
  iterations from step 0 (two warm-up, two through the static buffers):
  the flagship's ACGAN trainer, the GAN trainer in every mode, the
  semi-supervised trainer in every variant.
* ``chunk`` and ``epoch_scan`` keep the JAX semantics: the steps that ran,
  the chunks' means, and the state of ``chunk=1``.

Small widths and data throughout; ``tests/test_torch_gpu.py`` holds the
captured step against the eager one on the card."""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctgan_tpu.train import optim as jax_optim
from ctgan_tpu.train import schedules as jax_schedules

from ctgan_tpu_torch.apps import ct_cifar_ssl, ct_gan_64x64, ct_gan_mnist, ct_mnist_ssl, ssl_common
from ctgan_tpu_torch.apps import ct_gan_cifar_resnet as flagship_app
from ctgan_tpu_torch.apps.common import gan_batches
from ctgan_tpu_torch.bridge import state_from_jax, state_to_jax
from ctgan_tpu_torch.core import Randomness
from ctgan_tpu_torch.core.rng import StaticRandomness, derive_seed
from ctgan_tpu_torch.data import synthetic_images
from ctgan_tpu_torch.train import AcganState, Adam, AdamTheano, GanState, RMSProp, SslState, linear_decay
from ctgan_tpu_torch.train.capture import CapturedStep, to_device
from ctgan_tpu_torch.train.loop import _Pending
from ctgan_tpu_torch.utils import MetricLogger, load_checkpoint

import torch_parity  # noqa: F401  (one intra-op thread per worker)
import torch_tiny_ssl

ITERS = 4  # steps 0-3: 0 and 1 warm up, 2 and 3 run through the static buffers
DRAWS = ("noise", "normal", "uniform", "labels", "gp_alpha", "flip", "crop_offsets", "dequant", "dropout_mask")
GAN_MODES = ("wgan-CT", "wgan-gp", "wgan", "dcgan", "lsgan")


class _Run:
    """A tiny app: ``fresh()`` its initial state (a new object each call),
    ``step_fn(state, *inputs(step), rand)`` its step, ``rand`` its base
    provider and ``state_cls`` for the bridge."""

    def __init__(self, state, step_fn, inputs, rand, state_cls):
        self._blob, self.step_fn, self.inputs, self.rand, self.state_cls = (
            state_to_jax(state), step_fn, inputs, rand, state_cls)

    def fresh(self):
        return state_from_jax(self._blob, "cpu", self.state_cls)


def _flagship(monkeypatch) -> _Run:
    x, y = synthetic_images(64, 3, 32, seed=0)
    monkeypatch.setattr(flagship_app, "load_arrays", lambda *a, **k: {"train": (x, y), "test": (x, y)})
    fl = flagship_app.setup(flagship_app.Config(DIM_G=8, DIM_D=8, BATCH_SIZE=4, N_CRITIC=2, ITERS=100), "cpu")
    return _Run(fl.state, flagship_app.make_step_fn(fl), lambda step: (fl.sampler.host_indices(step),),
                fl.rand, AcganState)


def _good64(monkeypatch, mode: str = "wgan-ct", cuda_dropout: bool = True) -> _Run:
    pool = synthetic_images(16, 3, 64, seed=0)
    cfg = ct_gan_64x64.Config(DIM=8, BATCH_SIZE=2, CRITIC_ITERS=2, MODE=mode, CUDA_DROPOUT=cuda_dropout)
    run = ct_gan_64x64.setup(cfg, "cpu", pool)
    return _Run(run.state, ct_gan_64x64.make_step_fn(run), gan_batches(run), run.rand, GanState)


def _mnist_gan(monkeypatch, mode: str = "wgan-CT") -> _Run:
    monkeypatch.setattr(ct_gan_mnist.mnist, "load_arrays", lambda *a, **k: torch_tiny_ssl.small_mnist())
    run = ct_gan_mnist.setup(ct_gan_mnist.Config(MODE=mode, DIM=4, BATCH_SIZE=4, CRITIC_ITERS=2, n_examples=64),
                             "cpu")
    return _Run(run.state, ct_gan_mnist.make_step_fn(run), gan_batches(run), run.rand, GanState)


def _ssl(monkeypatch, variant: str) -> _Run:
    torch_tiny_ssl.apply_small_data(monkeypatch.setattr)
    torch_tiny_ssl.apply_tiny_ssl_models(monkeypatch.setattr)
    if variant == "mnist":
        cfg = ct_mnist_ssl.Config(batch_size=20)
        app = ct_mnist_ssl.setup(cfg, "cpu")
    else:
        cfg = ct_cifar_ssl.Config(batch_size=20, temporal_ensembling=variant == "te")
        app = ct_cifar_ssl.setup(cfg, "cpu")
    n, bs = len(app.train), cfg.batch_size
    orders = [torch.from_numpy(o) for o in ssl_common.epoch_orders(cfg.seed, 0, n, len(app.labeled[0]))]
    gen = torch.Generator().manual_seed(5)
    ens = (torch.rand(n, 10, generator=gen), torch.randn(n, ssl_common.TE_FEATURES, generator=gen))

    def inputs(step):
        lab, unl, unl2 = (o[step * bs:(step + 1) * bs] for o in orders)
        return lab, unl, unl2, (ens[0][unl], ens[1][unl]) if variant == "te" else None

    return _Run(app.state, ssl_common.make_step_fn(app), inputs, app.rand, SslState)


APPS = {
    "flagship": _flagship,
    "good64": _good64,
    "mnist_gan": _mnist_gan,
    "ssl_mnist": functools.partial(_ssl, variant="mnist"),
    "ssl_cifar": functools.partial(_ssl, variant="cifar"),
}


def _logging(name):
    def method(self, *args):
        self.calls.append((name, args))
        return getattr(Randomness, name)(self, *args)

    return method


class _Logged(Randomness):
    """``Randomness`` that logs each draw's method and arguments."""

    calls: list

    def for_step(self, step):
        child = _Logged(derive_seed(self.seed, step), self.device)
        child.calls = self.calls
        return child


for _name in DRAWS:
    setattr(_Logged, _name, _logging(_name))


def _draw_sequence(run: _Run) -> list:
    """The draws of one eager step of ``run`` at step 1 (G's update taken)."""
    state = run.fresh()
    state.step = 1
    rand = _Logged(run.rand.seed, "cpu")
    rand.calls = []
    run.step_fn(state, *run.inputs(1), rand)
    return rand.calls


def _equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("step", [0, 1, 781])
@pytest.mark.parametrize("app", list(APPS))
def test_static_provider_draws_what_randomness_draws(monkeypatch, app, step):
    """Each draw of the app's sequence through the static buffer, filled for
    ``step``, equals ``Randomness(seed).for_step(step)``'s, and so does the
    seed table."""
    seq = _draw_sequence(APPS[app](monkeypatch))
    seed = 11
    provider = StaticRandomness(seed, "cpu")
    recorder = provider.record().for_step(5)
    for name, args in seq:
        getattr(recorder, name)(*args)
    provider.freeze([])
    assert len(provider.program) == sum(name not in ("dequant", "dropout_mask") for name, _ in seq)
    provider.fill(step, [])
    views = provider.for_step(step)
    want = Randomness(seed, "cpu").for_step(step)
    assert _equal(views.seeds, want.seeds)
    for i, (name, args) in enumerate(seq):
        assert _equal(getattr(views, name)(*args), getattr(want, name)(*args)), (i, name)
    assert views.used == len(provider.program)


def test_each_app_draws_what_it_should():
    """The sequences above hold what each app draws: crops and flips in the
    CIFAR-10 classifier, Gaussian noise in MNIST's, flips in the 64 px
    app's, the flagship's dequantisation noise."""
    with pytest.MonkeyPatch.context() as mp:
        seqs = {app: {name for name, _ in _draw_sequence(make(mp))} for app, make in APPS.items()}
    assert {"labels", "noise", "gp_alpha", "dequant", "dropout_mask"} <= seqs["flagship"]
    assert {"flip", "noise", "gp_alpha", "dropout_mask"} <= seqs["good64"]
    assert {"noise", "gp_alpha", "dropout_mask"} <= seqs["mnist_gan"]
    assert {"normal", "uniform"} <= seqs["ssl_mnist"] and "dropout_mask" not in seqs["ssl_mnist"]
    assert {"crop_offsets", "flip", "uniform", "dropout_mask"} <= seqs["ssl_cifar"]


def _jax_scalar(fn, *args) -> np.ndarray:
    return np.asarray(fn(*args), np.float32)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


OPTIMISERS = {"adam_flagship": (0.0, 0.9), "adam_good64": (0.5, 0.9), "adam_dcgan": (0.5, 0.999)}


@pytest.mark.parametrize("decay", [False, True])
@pytest.mark.parametrize("kind", [*OPTIMISERS, "adam_theano", "rmsprop"])
def test_optimiser_scalars_equal_jax(kind, decay):
    """Each update's fp32 scalars, computed on the host, against the JAX
    update's expressions (``ctgan_tpu/train/optim.py:77``, ``:104-106``,
    ``:122``) at t = 1, 2, 1,000 and 99,999, bit for bit.  They run eagerly,
    as ``tests/test_torch_train.py`` holds the schedule: under ``jax.jit``
    XLA turns ``step / total`` into ``step * fl(1 / total)`` fused with the
    subtraction, one ulp of the fraction apart (855 ulps of the decayed rate
    at step 99,998 of 100,000, where the fraction is 2e-5)."""
    lr, total = 2e-4, 100000
    port_lr = linear_decay(lr, total) if decay else lr
    jax_lr = jax_schedules.linear_decay(lr, total) if decay else lr
    for t in (1, 2, 1000, 99999):
        step = t - 1
        t32, s32 = jnp.asarray(t, jnp.float32), jnp.asarray(step, jnp.int32)
        if kind in OPTIMISERS:
            b1, b2 = OPTIMISERS[kind]
            got = Adam(port_lr, b1, b2).scalars(float(t), step)
            want = [_jax_scalar(lambda t, s: jax_optim._resolve_lr(jax_lr, s) * jnp.sqrt(1.0 - b2**t)
                                / (1.0 - b1**t), t32, s32)]
        elif kind == "adam_theano":
            got = AdamTheano(port_lr, 0.5).scalars(float(t), step)
            want = [_jax_scalar(lambda t: 1.0 - 0.5**t, t32), _jax_scalar(lambda t: 1.0 - 0.999**t, t32),
                    _jax_scalar(lambda s: jax_optim._resolve_lr(jax_lr, s), s32)]
        else:
            got = RMSProp(port_lr).scalars(step)
            want = [_jax_scalar(lambda s: jax_optim._resolve_lr(jax_lr, s), s32)]
        assert got.dtype == np.float32
        np.testing.assert_array_equal(_bits(got), _bits(np.stack(want)), err_msg=f"t={t}")


def _outputs_equal(got, want) -> None:
    if isinstance(got, dict):
        assert got.keys() == want.keys()
        for k in want:
            _outputs_equal(got[k], want[k])
    elif isinstance(got, (tuple, list)):
        for g, w in zip(got, want, strict=True):
            _outputs_equal(g, w)
    elif isinstance(got, torch.Tensor):
        assert _equal(got.detach(), want.detach())


def _trees_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            _trees_equal(got[k], v)
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


def _strip_state(out):
    """A GAN step's ``(state, metrics)`` -> metrics; an SSL step's outputs
    as they are."""
    return out[1] if isinstance(out[0], (AcganState, GanState)) else out


def _captured_against_eager(run: _Run, iters: int = ITERS) -> CapturedStep:
    eager, captured = run.fresh(), run.fresh()
    step = CapturedStep(run.step_fn, run.rand, name="test step", graph=False)
    for it in range(iters):
        want = _strip_state(run.step_fn(eager, *to_device(run.inputs(it), "cpu"), run.rand))
        got = _strip_state(step(captured, *run.inputs(it)))
        _outputs_equal(got, want)
    _trees_equal(state_to_jax(captured), state_to_jax(eager))
    assert captured.step == eager.step == iters
    assert step.warmup_calls == 2 and step.provider.filled_step == iters - 1
    return step


@pytest.mark.parametrize("app", ["flagship", "good64", "good64_plain_mask", "ssl_mnist", "ssl_cifar", "ssl_te"])
def test_capturable_step_equals_the_eager_step(monkeypatch, app):
    """Steps 0-3 through ``CapturedStep(graph=False)`` against the eager
    step: metrics each step, then every parameter, moment, ``t`` and the
    step, bit for bit.  ``good64_plain_mask`` is ``CUDA_DROPOUT=False``:
    the static buffers' plain masks read their seeds from the device table,
    the eager step's from the host."""
    extra = {"ssl_te": functools.partial(_ssl, variant="te"),
             "good64_plain_mask": functools.partial(_good64, cuda_dropout=False)}
    make = extra.get(app) or APPS[app]
    step = _captured_against_eager(make(monkeypatch))
    assert any(e.kind == "host" for e in step.provider.program)  # the optimisers' scalars


@pytest.mark.parametrize("mode", GAN_MODES)
def test_capturable_gan_step_equals_the_eager_step_in_every_mode(monkeypatch, mode):
    """The GAN trainer through the MNIST app's step in each mode (RMSProp
    and the weight clip in ``wgan``, one critic substep in ``dcgan``)."""
    _captured_against_eager(_mnist_gan(monkeypatch, mode))


def test_a_step_that_draws_otherwise_raises(monkeypatch):
    """A step whose draws differ from its warm-up step's fails loudly."""
    calls = []

    def step_fn(state, rand):
        rand = rand.for_step(state.step)
        calls.append(state.step)
        rand.noise(2, 3) if state.step < 2 else rand.gp_alpha(2)
        state.step += 1
        return state, {}

    state = GanState({}, {}, {}, {}, 0)
    step = CapturedStep(step_fn, Randomness(0, "cpu"), name="odd", graph=False)
    step(state)
    step(state)
    with pytest.raises(RuntimeError, match="asks for gp_alpha"):
        step(state)


def test_a_new_state_warms_up_again(monkeypatch):
    """Another state object (a loaded checkpoint) starts a new warm-up."""
    run = _good64(monkeypatch)
    step = CapturedStep(run.step_fn, run.rand, name="good64", graph=False)
    state = run.fresh()
    for it in range(3):
        step(state, *run.inputs(it))
    assert step.provider.program is not None
    other = state_from_jax(state_to_jax(state), "cpu", GanState)
    step(other, *run.inputs(3))
    assert step.provider.program is not None and step.warmup_calls == 3  # step 3 warms up and fixes the layout
    step(other, *run.inputs(4))
    assert other.step == 5


def test_pending_add_copies_the_metrics():
    """The loop keeps a copy of each iteration's metrics: a replay that
    overwrites its static outputs leaves the logged values alone."""
    logger = MetricLogger()
    pending = _Pending(logger)
    static = {"cost": torch.tensor(1.5), "gp": torch.tensor(0.25)}
    pending.add(static)
    static["cost"].fill_(99.0)
    static["gp"].fill_(-1.0)
    pending.add(static)
    pending.drain()
    assert logger.flush()["cost"] == (1.5 + 99.0) / 2 and logger.records[-1]["gp"] == (0.25 - 1.0) / 2


@pytest.fixture
def small_ssl(monkeypatch):
    torch_tiny_ssl.apply_small_data(monkeypatch.setattr)
    torch_tiny_ssl.apply_tiny_ssl_models(monkeypatch.setattr)


SSL_APPS = {"mnist": ct_mnist_ssl, "cifar": ct_cifar_ssl}


def _ssl_run(app: str, out_dir, **kw):
    module = SSL_APPS[app]
    return module.main(cfg=module.Config(out_dir=str(out_dir), epochs=1, **kw), device="cpu")


@pytest.mark.parametrize("app,flag", [("mnist", {"epoch_scan": True}), ("cifar", {"epoch_scan": True}),
                                      ("cifar", {"chunk": 25})])
def test_jax_dispatch_modes_run(small_ssl, tmp_path, app, flag):
    """Each JAX dispatch mode runs and ends with ``chunk=1``'s state bit for
    bit (every batch of the small epochs ran: 6 MNIST steps, 2 CIFAR-10
    steps, in one chunk of 25), its logged means within 1e-6."""
    state, records = _ssl_run(app, tmp_path / "mode", **flag)
    want_state, want_records = _ssl_run(app, tmp_path / "one")
    _trees_equal(state_to_jax(state), state_to_jax(want_state))
    assert state.step == want_state.step == (6 if app == "mnist" else 2)
    (got,), (want,) = records, want_records
    names = (*ssl_common.METRICS["mnist" if app == "mnist" else "cifar"], "test_err")
    for k in names:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def _record_step_metrics(monkeypatch) -> list:
    """Every step's metrics of the next SSL run, in order."""
    rows, make = [], ssl_common.make_step_fn

    def recording(app):
        step_fn = make(app)

        def run(*args):
            out = step_fn(*args)
            rows.append({k: float(v) for k, v in out[0].items()})
            return out

        return run

    monkeypatch.setattr(ssl_common, "make_step_fn", recording)
    return rows


def test_chunk_with_a_ragged_tail(small_ssl, monkeypatch, tmp_path):
    """Batch 20 gives 10 batches; chunks of 4 run 8 steps (the ragged tail
    of 2 dropped) and log the mean of the two chunks' means, as
    ``ctgan_tpu/apps/ct_cifar_ssl.py:301-330`` does."""
    rows = _record_step_metrics(monkeypatch)
    state, (record,) = _ssl_run("cifar", tmp_path, batch_size=20, chunk=4)
    assert state.step == len(rows) == 8 == (10 // 4) * 4
    for k in ("loss_lab", "loss_unl", "train_err", "loss_gen"):
        vals = np.array([r[k] for r in rows], np.float64)
        np.testing.assert_allclose(record[k], (vals[:4].mean() + vals[4:].mean()) / 2, rtol=1e-6, err_msg=k)
    assert ssl_common.chunks(10, 4) == [(0, 4), (4, 8)] and ssl_common.chunks(2, 25) == [(0, 2)]
    assert ssl_common.chunks(10, 4, epoch_scan=True) == [(0, 10)]


@pytest.mark.parametrize("variant", ["cifar", "te"])
def test_chunk_without_a_tail_and_epoch_scan_equal_chunk_1(small_ssl, tmp_path, variant):
    """Chunks of 5 of 10 batches, and ``epoch_scan``, end with ``chunk=1``'s
    state (the ensemble buffers too) bit for bit."""
    extra = {"batch_size": 20, "temporal_ensembling": variant == "te"}
    want, _ = _ssl_run("cifar", tmp_path / "one", **extra)
    for name, flag in (("five", {"chunk": 5}), ("scan", {"epoch_scan": True})):
        got, _ = _ssl_run("cifar", tmp_path / name, **extra, **flag)
        assert got.step == 10
        _trees_equal(load_checkpoint(str(tmp_path / name / "ssl_state.npz")),
                     load_checkpoint(str(tmp_path / "one" / "ssl_state.npz")))


def test_mnist_chunk_of_50_logs_the_steps_mean():
    """The JAX MNIST app logs the mean of chunks of 50 batches
    (``ctgan_tpu/apps/ct_mnist_ssl.py:99``); 50 divides its 60,000 / 100 =
    600 batches, so the port's mean over the steps is the same to rounding."""
    n_batches = 60000 // ct_mnist_ssl.Config().batch_size
    assert n_batches % 50 == 0
    rows = torch.from_numpy(np.random.default_rng(0).normal(size=(n_batches, 4)).astype(np.float32) + 3)
    chunked = ssl_common.epoch_means(rows, ssl_common.chunks(n_batches, 50))
    stepped = ssl_common.epoch_means(rows, ssl_common.chunks(n_batches, 1))
    np.testing.assert_allclose(chunked, stepped, rtol=1e-6)
    np.testing.assert_allclose(stepped, rows.double().mean(0).numpy(), rtol=1e-12)


@pytest.fixture(scope="module")
def chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_captured_equal_covers_every_trainer(chip_smoke):
    assert list(chip_smoke.captured_trainers("cpu")) == [
        "flagship", "good64", "mnist", "cifar", "lsun128", "ssl_cifar", "ssl_mnist"]


@pytest.mark.parametrize("app", ["good64", "ssl_cifar"])
def test_captured_equal_phase_rehearses_on_cpu(chip_smoke, monkeypatch, app, capsys):
    """The card's ``captured_equal`` phase at small widths (both arms eager
    here): equal states and metrics, no launches on the CPU, the chunk
    means of the semi-supervised step."""
    run = APPS[app](monkeypatch)
    tr = chip_smoke._Trainer(app, state_to_jax(run.fresh()), run.state_cls, run.step_fn, run.inputs,
                             run.rand.seed, masks=63, uniforms=0)
    out = chip_smoke.phase_captured_equal("cpu", tr, 4, chunk=2 if app == "ssl_cifar" else 1)
    assert out["state_diff"] == out["metric_diff"] == 0 and out["masks"] == 0 and out["timed"] == 3
    assert not out["captured"] and out["peak_bytes"] is None
    assert f"captured_equal_{app} on cpu: 4 iterations from step 0" in capsys.readouterr().out


def test_epoch_scan_equal_phase_rehearses_on_cpu(chip_smoke, small_ssl, tmp_path):
    """The card's ``epoch_scan_equal`` phase on the small MNIST data: the
    app's first epoch with ``epoch_scan`` against its ``chunk=1`` run."""
    state, records = _ssl_run("mnist", tmp_path / "one")
    first_epoch = load_checkpoint(str(tmp_path / "one" / "ssl_state.npz"))["state"]
    out = chip_smoke.phase_epoch_scan_equal("cpu", first_epoch, str(tmp_path / "scan"), records)
    assert out["state_diff"] == 0 and out["means_rel"] <= 1e-6 and out["steps"] == state.step == 6
