"""``ctgan_tpu_torch``'s host-side library modules against ``ctgan_tpu``'s
on the CPU: the auxiliary loaders (``data/aux_loaders.py``), random search,
the handwriting utilities and the experiment helpers.

Tolerance: none.  These are NumPy code on both sides, so every array is
equal element for element (bf16 leaves bit for bit) and every string and
config equal, for the same arguments and seeds.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

import torch

from ctgan_tpu.data import aux_loaders as jax_aux
from ctgan_tpu.utils import experiments as jax_exp
from ctgan_tpu.utils import handwriting as jax_hw
from ctgan_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from ctgan_tpu.utils.random_search import random_search as jax_random_search

from ctgan_tpu_torch.bridge import from_jax_params
from ctgan_tpu_torch.data import aux_loaders as port_aux
from ctgan_tpu_torch.utils import MetricLogger
from ctgan_tpu_torch.utils import experiments as port_exp
from ctgan_tpu_torch.utils import handwriting as port_hw
from ctgan_tpu_torch.utils.random_search import random_search as port_random_search

SEEDS = (0, 3)


def _assert_trees_equal(got, want):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _take(gen, n: int | None) -> list:
    out = []
    for batch in gen:
        out.append(batch)
        if n is not None and len(out) == n:
            break
    return out


def _epochs(factory, n_calls: int = 2, n: int | None = None) -> list:
    """The batches of ``n_calls`` calls of an epoch factory (the first
    ``n`` of each)."""
    return [_take(factory(), n) for _ in range(n_calls)]


def _write_images(directory, sizes=((40, 30), (24, 24), (30, 50))):
    from PIL import Image

    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(11)
    for i, (w, h) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(directory / f"img{i}.png")
    (directory / "notes.txt").write_text("not an image")
    return directory


def _svhn_mat(path, n: int = 40):
    from scipy.io import savemat

    rng = np.random.default_rng(5)
    savemat(path, {"X": rng.integers(0, 256, (32, 32, 3, n), dtype=np.uint8),
                   "y": rng.integers(1, 11, (n, 1)).astype(np.uint8)})
    return str(path)


CASES = {
    "svhn": lambda aux, seed, tmp: _epochs(aux.svhn_generator(64, seed=seed), n=3),
    "svhn_mat": lambda aux, seed, tmp: _epochs(aux.svhn_generator(8, _svhn_mat(tmp / "svhn.mat"), seed=seed)),
    "enwik8": lambda aux, seed, tmp: _epochs(aux.enwik8_generator(8, 64, seed=seed), n=3),
    "enwik8_file": lambda aux, seed, tmp: _epochs(aux.enwik8_generator(
        4, 16, path=str(_bytes_file(tmp / "text.bin")), seed=seed)),
    "mnist_256": lambda aux, seed, tmp: _epochs(aux.mnist_256_generator(16, seed=seed, n_examples=64)),
    "mnist_binarized": lambda aux, seed, tmp: _epochs(aux.mnist_binarized_generator(16, seed=seed,
                                                                                    n_examples=64)),
    "small_imagenet_32": lambda aux, seed, tmp: _take(aux.small_imagenet_32_generator(8, seed=seed), 3),
    "small_imagenet_32_dir": lambda aux, seed, tmp: _take(aux.small_imagenet_32_generator(
        2, str(_write_images(tmp / "imgs")), seed=seed), 4),
    "lsun256_dir": lambda aux, seed, tmp: _take(aux.lsun256_generator(2, str(_write_images(tmp / "imgs")),
                                                                      seed=seed), 3),
    "lsun256_test": lambda aux, seed, tmp: _take(aux.lsun256_test_generator(3, seed=seed + 7), 2),
    "audio": lambda aux, seed, tmp: _epochs(aux.audio_generator(2, seq_len=512, seed=seed)),
}


def _bytes_file(path):
    path.write_bytes(np.random.default_rng(2).integers(0, 256, 1000, dtype=np.uint8).tobytes())
    return path


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", list(CASES))
def test_aux_generators_equal_jax(case, seed, tmp_path):
    """Every generator's batches, over two epochs where it is a factory of
    epochs, equal JAX's for the same arguments (real files where the
    generator reads them, else its synthetic data)."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = CASES[case](jax_aux, seed, tmp_path / "jax")
    got = CASES[case](port_aux, seed, tmp_path / "port")
    _assert_trees_equal(got, want)


def test_svhn_mat_labels_and_layout(tmp_path):
    """The ``.mat`` path: HWCN pixels flattened C-major, labels mod 10."""
    path = _svhn_mat(tmp_path / "svhn.mat", n=8)
    x, y = next(port_aux.svhn_generator(8, path, seed=0)())
    from scipy.io import loadmat

    d = loadmat(path)
    order = [int(np.flatnonzero((d["X"].transpose(3, 2, 0, 1).reshape(8, -1) == row).all(1))[0]) for row in x]
    np.testing.assert_array_equal(y, d["y"].reshape(-1)[order].astype(np.int64) % 10)


def test_convert_image_folder_equals_jax(tmp_path):
    from PIL import Image

    src = _write_images(tmp_path / "src")
    want_n = jax_aux.convert_image_folder(str(src), str(tmp_path / "jax"), size=16)
    got_n = port_aux.convert_image_folder(str(src), str(tmp_path / "port"), size=16)
    assert got_n == want_n == 3
    for i in range(3):
        got, want = (np.asarray(Image.open(tmp_path / d / f"{i}.png")) for d in ("port", "jax"))
        assert got.shape == (16, 16, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grid,n_splits,seed", [
    ({"lr": [1e-4, 2e-4, 5e-4], "dim": [64, 128]}, 1, 0),
    ({"lr": [1e-4, 2e-4, 5e-4], "dim": [64, 128], "bn": [True, False]}, 3, 7),
    ({"mode": ["wgan-ct", "wgan-gp"], "critic": [1, 5], "beta1": [0.0, 0.5]}, 2, 123),
])
def test_random_search_equals_jax(grid, n_splits, seed):
    for split in range(n_splits):
        assert port_random_search(grid, n_splits, split, seed) == jax_random_search(grid, n_splits, split, seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_handwriting_equals_jax(seed):
    rng = np.random.default_rng(seed)
    strokes = np.concatenate([rng.normal(scale=5.0, size=(40, 2)), (rng.random((40, 1)) < 0.15)], axis=1)
    strokes = strokes.astype(np.float32)
    _assert_trees_equal(port_hw.strokes_to_points(strokes), jax_hw.strokes_to_points(strokes))
    _assert_trees_equal(port_hw.normalize_strokes(strokes, 2.0), jax_hw.normalize_strokes(strokes, 2.0))
    for size, margin in ((64, 8), (32, 2)):
        got = port_hw.render_strokes(strokes, size, margin)
        _assert_trees_equal(got, jax_hw.render_strokes(strokes, size, margin))
        assert got.max() == 255


# ------------------------------------------------------------------ experiments

def _jax_params(seed: int) -> dict:
    """A small parameter dict in the JAX layout: a conv filter, a linear
    weight, a bias and a bf16 moment-like leaf."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    return {"D.Conv.Filters": jnp.asarray(rng.normal(size=(3, 3, 2, 4)).astype(np.float32)),
            "D.Out.W": jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32)),
            "D.Out.b": jnp.asarray(rng.normal(size=3).astype(np.float32)),
            "D.Half.W": jnp.asarray(rng.normal(size=(4, 2)), jnp.bfloat16)}


def _port(params: dict) -> dict:
    return from_jax_params({k: np.asarray(v) for k, v in params.items()})


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("minimize,track", [(True, True), (False, True), (True, False)])
def test_best_param_saver_checkpoint_loads_equal_in_jax(minimize, track, tmp_path):
    """The same evaluations in both packages; the port's
    ``trained_params.npz`` read by JAX's ``load_checkpoint`` equals JAX's
    own, the bf16 leaf bit for bit."""
    values = [3.0, None, 1.0, 2.0]
    savers = {"jax": jax_exp.BestParamSaver(str(tmp_path / "jax"), minimize=minimize, track=track),
              "port": port_exp.BestParamSaver(str(tmp_path / "port"), minimize=minimize, track=track)}
    for i, value in enumerate(values):
        params = _jax_params(i)
        assert (savers["port"].update(value, _port(params)) == savers["jax"].update(value, params))
        assert savers["port"].best_value == savers["jax"].best_value
    loaded = {name: jax_load_checkpoint(saver.save()) for name, saver in savers.items()}
    assert set(loaded["port"]) == set(loaded["jax"]) == set(_jax_params(0))
    for k, want in loaded["jax"].items():
        got = loaded["port"][k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=k)


def test_best_param_saver_snapshot_survives_in_place_updates(tmp_path):
    """The port's optimisers update parameters in place: the snapshot is a
    host copy, not a view of the live tensors."""
    params = _port(_jax_params(0))
    want = {k: v.clone() for k, v in params.items()}
    saver = port_exp.BestParamSaver(str(tmp_path))
    assert saver.update(1.0, params)
    with torch.no_grad():
        for v in params.values():
            v.add_(5.0)
    assert not saver.update(2.0, params)
    got = from_jax_params(jax_load_checkpoint(saver.save()))
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert port_exp.BestParamSaver(str(tmp_path / "none")).save() is None


def test_load_log_of_a_port_log_equals_jax(tmp_path):
    """A port ``MetricLogger``'s ``log.ndjson`` (a channel missing from the
    first row) read by both packages' ``load_log``."""
    logger = MetricLogger(str(tmp_path))
    for it, row in enumerate(({"err": 0.5}, {"err": 0.25, "extra": 1.0}, {"extra": 2.0})):
        for name, value in row.items():
            logger.plot(name, value)
        logger.tick()
        logger.flush()
    got, want = port_exp.load_log(str(tmp_path)), jax_exp.load_log(str(tmp_path))
    assert list(got) == list(want) and {"err", "extra", "iteration", "wall_time"} <= set(got)
    for k in want:
        assert len(got[k]) == len(want[k]) == 3
        for g, w in zip(got[k], want[k]):
            assert (math.isnan(g) and math.isnan(w)) or g == w, k


def test_prepare_dir_numbers_like_jax(tmp_path):
    got = [port_exp.prepare_dir("exp", str(tmp_path / "port")) for _ in range(3)]
    want = [jax_exp.prepare_dir("exp", str(tmp_path / "jax")) for _ in range(3)]
    assert [p.replace(str(tmp_path / "port"), "") for p in got] == [
        p.replace(str(tmp_path / "jax"), "") for p in want] == ["/exp0", "/exp1", "/exp2"]
    (tmp_path / "port" / "run5").mkdir()
    (tmp_path / "port" / "run0").mkdir()
    assert port_exp.prepare_dir("run", str(tmp_path / "port")).endswith("run1")


def test_exp_params_and_attribute_dict_equal_jax(tmp_path):
    cfg = {"lr": np.float32(2e-4), "dims": np.arange(3), "name": "x", "iters": np.int64(7)}
    port_exp.save_exp_params(str(tmp_path / "port"), cfg)
    jax_exp.save_exp_params(str(tmp_path / "jax"), cfg)
    assert (tmp_path / "port" / "params.json").read_text() == (tmp_path / "jax" / "params.json").read_text()
    back = port_exp.load_exp_params(str(tmp_path / "port"))
    assert back == jax_exp.load_exp_params(str(tmp_path / "jax")) and back.dims == [0, 1, 2]
    back.extra = 1
    assert back["extra"] == 1
    with pytest.raises(AttributeError):
        back.missing


@pytest.mark.parametrize("to_print", [
    {"E": ["train_err", "test_err"], "C": "cost", "N": None},
    {"acc": ("acc_a", "acc_b"), "missing": "nothing"},
])
def test_short_format_and_filter_funcs_prefix_equal_jax(to_print):
    row = {"train_err": 0.1234, "cost": 2.5, "acc_a": 1e-5, "acc_b": 123456.0}
    assert port_exp.short_format(3, 120, row, to_print) == jax_exp.short_format(3, 120, row, to_print)
    funcs = {"cmd_train": 1, "cmd_eval": 2, "x_cmd_plot": 3, "other": 4, "run_fast": 5}
    for pfx in ("cmd_", "run_", "zzz"):
        assert port_exp.filter_funcs_prefix(funcs, pfx) == jax_exp.filter_funcs_prefix(funcs, pfx)
    assert json.dumps(port_exp.filter_funcs_prefix(funcs)) == json.dumps(jax_exp.filter_funcs_prefix(funcs))
