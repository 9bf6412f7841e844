"""The port's semi-supervised apps through ``main(..., device="cpu")``: a
resumed run equals an uninterrupted one in every variant (the ensemble
buffers too), ``ssl_state.npz`` moves between the JAX app and the port both
ways, the approximate resume from the tracked parameter files, the
fresh-start guard.  The JAX dispatch modes (``chunk``, ``epoch_scan``) are
in ``tests/test_torch_capture.py``.

MNIST runs its real nets on 600 synthetic images (6 steps an epoch);
CIFAR-10 runs ``tests/torch_tiny_ssl.py``'s tiny nets on 200 (2 steps).
On the CPU every run is deterministic, so states compare exactly.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from ctgan_tpu_torch.apps import ct_cifar_ssl as port_cifar
from ctgan_tpu_torch.apps import ct_mnist_ssl as port_mnist
from ctgan_tpu_torch.bridge import state_to_jax
from ctgan_tpu_torch.utils import load_checkpoint

import torch_parity  # noqa: F401  (one intra-op thread per worker)
import torch_tiny_ssl

VARIANTS = {"mnist": (port_mnist, {}), "cifar": (port_cifar, {}), "te": (port_cifar, {"temporal_ensembling": True})}


@pytest.fixture
def small(monkeypatch):
    torch_tiny_ssl.apply_small_data(monkeypatch.setattr)
    torch_tiny_ssl.apply_tiny_ssl_models(monkeypatch.setattr)


def _run(variant: str, out_dir, **kw):
    module, extra = VARIANTS[variant]
    return module.main(cfg=module.Config(out_dir=str(out_dir), **extra, **kw), device="cpu")


def _leaves(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}


def _saved(out_dir) -> dict:
    return _leaves(load_checkpoint(str(out_dir / "ssl_state.npz")))


def _assert_equal_trees(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("variant", ["mnist", "cifar", "te"])
def test_resumed_equals_uninterrupted(small, tmp_path, variant, capsys):
    _run(variant, tmp_path / "whole", epochs=2)
    _run(variant, tmp_path / "resumed", epochs=1)
    capsys.readouterr()
    state, records = _run(variant, tmp_path / "resumed", epochs=2)
    assert f"resumed from {tmp_path / 'resumed' / 'ssl_state.npz'} at epoch 1" in capsys.readouterr().out
    assert [r["iteration"] for r in records] == [2] and state.step == (12 if variant == "mnist" else 4)
    whole, resumed = _saved(tmp_path / "whole"), _saved(tmp_path / "resumed")
    _assert_equal_trees(resumed, whole)
    if variant != "mnist":
        assert {"/ensemble", "/ensemble2", "/targets", "/targets2", "/ens_base"} <= whole.keys()
        assert np.any(whole["/targets2"] != 0) == (variant == "te")
    for name in ("disc_params", "gen_params", "avg_params"):
        _assert_equal_trees(_leaves(load_checkpoint(str(tmp_path / "resumed" / f"{name}.npz"))),
                            _leaves(load_checkpoint(str(tmp_path / "whole" / f"{name}.npz"))))


def _jax_state_leaves(state) -> dict:
    return _leaves({k: jax_tree_to_np(v) for k, v in state._asdict().items()})


def jax_tree_to_np(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_to_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _small_jax_data(monkeypatch):
    import ctgan_tpu.data.cifar10 as jax_cifar
    import ctgan_tpu.data.mnist as jax_mnist

    monkeypatch.setattr(jax_mnist, "load_arrays", torch_tiny_ssl.small_mnist)
    monkeypatch.setattr(jax_cifar, "load_normalized", torch_tiny_ssl.small_cifar)


def test_mnist_state_moves_between_jax_and_the_port(small, monkeypatch, tmp_path, capsys):
    """A JAX run's ``ssl_state.npz`` resumes in the port (loaded exactly,
    then trained on), and a port run's resumes in the JAX app (loaded
    exactly)."""
    from ctgan_tpu.apps import ct_mnist_ssl as jax_mnist_app

    _small_jax_data(monkeypatch)
    jax_state = jax_mnist_app.main(cfg=jax_mnist_app.Config(epochs=1, out_dir=str(tmp_path / "jax")))
    state, records = _run("mnist", tmp_path / "jax", epochs=1)  # nothing left to train: the loaded state
    assert records == [] and f"resumed from {tmp_path / 'jax' / 'ssl_state.npz'} at epoch 1" in capsys.readouterr().out
    _assert_equal_trees(_leaves(state_to_jax(state)), _jax_state_leaves(jax_state))
    state, records = _run("mnist", tmp_path / "jax", epochs=2)
    assert [r["iteration"] for r in records] == [2] and state.step == 12

    port_state, _ = _run("mnist", tmp_path / "port", epochs=1)
    loaded = jax_mnist_app.main(cfg=jax_mnist_app.Config(epochs=1, out_dir=str(tmp_path / "port")))
    _assert_equal_trees(_jax_state_leaves(loaded), _leaves(state_to_jax(port_state)))


def test_te_state_with_its_ensemble_moves_from_jax_to_the_port(small, monkeypatch, tmp_path):
    """The JAX app's temporal-ensembling state (tiny_ssl.py's nets): the
    port loads its state exactly and trains on from it, the ensemble's
    start epoch kept."""
    from tiny_ssl import apply_tiny_ssl_models

    from ctgan_tpu.apps import ct_cifar_ssl as jax_cifar_app

    _small_jax_data(monkeypatch)
    apply_tiny_ssl_models(setter=monkeypatch.setattr)
    jax_cfg = jax_cifar_app.Config(epochs=1, temporal_ensembling=True, out_dir=str(tmp_path / "te"))
    jax_cifar_app.main(cfg=jax_cfg)
    written = _saved(tmp_path / "te")
    assert np.any(written["/targets"] != 0)
    state, _ = _run("te", tmp_path / "te", epochs=1)  # nothing left to train: the loaded state
    _assert_equal_trees(_leaves(state_to_jax(state)), {k[len("/state"):]: v for k, v in written.items()
                                                       if k.startswith("/state/")})
    state, records = _run("te", tmp_path / "te", epochs=2)
    assert [r["iteration"] for r in records] == [2] and state.step == 4
    assert int(load_checkpoint(str(tmp_path / "te" / "ssl_state.npz"))["ens_base"]) == 0


def test_approximate_resume_from_the_tracked_files(small, tmp_path, capsys):
    """With ``ssl_state.npz`` gone: params exact from the three files, the
    optimiser re-warmed, the ensemble's bias correction counting from the
    resumed epoch; without ``avg_params.npz`` the average starts at D's
    params."""
    out = tmp_path / "run"
    _run("te", out, epochs=1)
    files = {n: _leaves(load_checkpoint(str(out / f"{n}.npz"))) for n in ("disc_params", "gen_params", "avg_params")}
    os.remove(out / "ssl_state.npz")
    capsys.readouterr()
    state, records = _run("te", out, epochs=1)
    assert records == [] and "resumed (approximate)" in capsys.readouterr().out
    saved = _leaves(state_to_jax(state))
    for name, leaves in files.items():
        _assert_equal_trees({k: v for k, v in saved.items() if k.startswith(f"/{name}/")},
                            {f"/{name}{k}": v for k, v in leaves.items()})
    assert state.step == 0 and state.disc_opt["t"] == 1.0
    assert all(not np.any(v) for k, v in saved.items() if k.startswith("/disc_opt/m/"))
    state, records = _run("te", out, epochs=2)
    assert [r["iteration"] for r in records] == [2]
    assert int(load_checkpoint(str(out / "ssl_state.npz"))["ens_base"]) == 1

    os.remove(out / "ssl_state.npz")
    os.remove(out / "avg_params.npz")
    state, _ = _run("te", out, epochs=2)
    _assert_equal_trees({k.replace("/avg_params/", "/"): v for k, v in _leaves(state_to_jax(state)).items()
                         if k.startswith("/avg_params/")},
                        {k.replace("/disc_params/", "/"): v for k, v in _leaves(state_to_jax(state)).items()
                         if k.startswith("/disc_params/")})


def test_fresh_start_guard(small, tmp_path):
    out = tmp_path / "run"
    _run("mnist", out, epochs=1)
    for name in ("ssl_state.npz", "disc_params.npz"):
        os.remove(out / name)
    with pytest.raises(SystemExit, match="REFUSING to train from epoch 0"):
        _run("mnist", out, epochs=2)
    state, records = _run("mnist", out, epochs=1, allow_fresh_start=True)
    assert state.step == 6 and [r["iteration"] for r in records] == [1]


def test_config_flags_parse():
    cfg = port_cifar.parse_config(["--temporal_ensembling", "true", "--epochs", "3", "--learning_rate", "1e-4"])
    assert cfg.temporal_ensembling and cfg.epochs == 3 and cfg.learning_rate == 1e-4 and cfg.count == 400
    assert port_mnist.parse_config([]) == port_mnist.Config()
    defaults = port_mnist.Config()
    assert (defaults.learning_rate, defaults.LAMBDA_2, defaults.epochs, defaults.count) == (3e-3, 0.1, 300, 10)
