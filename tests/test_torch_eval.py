"""The port's IS/FID metrics and TrainedScorer against ``ctgan_tpu``'s on the
CPU, with the committed scorer ``runs/flagship_fused_r4/scorer.npz``."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

from ctgan_tpu.apps import common as jax_common
from ctgan_tpu.core import init_context, split_params
from ctgan_tpu.eval import inception2015
from ctgan_tpu.eval import metrics as jax_metrics
from ctgan_tpu.eval.scorer import TrainedScorer as JaxScorer
from ctgan_tpu.eval.scorer import scorer_net as jax_scorer_net
from ctgan_tpu.utils import load_checkpoint as jax_load_checkpoint

from ctgan_tpu_torch.apps import common
from ctgan_tpu_torch.apps.common import find_inception_file, pick_scorer
from ctgan_tpu_torch.bridge import to_jax_params
from ctgan_tpu_torch.data.synthetic import synthetic_images
from ctgan_tpu_torch.eval import TrainedScorer, fid_from_features, inception_score_from_probs
from ctgan_tpu_torch.eval import inception2015 as port_inception2015
from ctgan_tpu_torch.eval import init_scorer_params
from ctgan_tpu_torch.train.optim import adam_mismatches
from ctgan_tpu_torch.utils import load_checkpoint

import torch_parity  # noqa: F401  (one intra-op thread per test worker)

ROOT = Path(__file__).resolve().parents[1]
SCORER = ROOT / "runs" / "flagship_fused_r4" / "scorer.npz"


def test_inception_score_equals_jax():
    """float64 NumPy on both sides: equal to 1e-10 relative."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(1000, 10)) * 3
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    for splits in (10, 7):
        got = inception_score_from_probs(probs, splits)
        want = jax_metrics.inception_score_from_probs(probs, splits)
        np.testing.assert_allclose(got, want, rtol=1e-10)


def test_fid_equals_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(300, 16))
    b = rng.normal(loc=0.5, scale=1.3, size=(200, 16))
    np.testing.assert_allclose(fid_from_features(a, b), jax_metrics.fid_from_features(a, b), rtol=1e-10)
    assert fid_from_features(a, a) < 1e-6


@pytest.mark.parametrize("dim,seed", [(8, 3), (64, 0)])
def test_fresh_scorer_params_equal_jax(dim, seed):
    """Same names, shapes and values as JAX's ``init_context(seed)``."""
    with init_context(seed=seed) as ctx:
        jax_scorer_net(jnp.zeros((2, 3072)), 3, 32, dim)
    want = split_params(ctx.params, "Scorer")[0]
    got = init_scorer_params(3, dim, seed)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.fixture(scope="module")
def test_images():
    return synthetic_images(64, 3, 32, seed=4322)


def test_committed_scorer_loads_unchanged(tmp_path):
    scorer = TrainedScorer(3, 32, cache_path=str(SCORER), device="cpu")
    want = jax_load_checkpoint(str(SCORER))
    got = to_jax_params(scorer.params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert scorer.comparable is False


def test_scorer_net_equals_jax_on_the_committed_scorer(test_images):
    """Logits and features of 64 synthetic test images: fp32 convs and
    batch norms in two summation orders, so rtol 1e-5 / atol 1e-5."""
    images, labels = test_images
    port = TrainedScorer(3, 32, cache_path=str(SCORER), device="cpu")
    jax = JaxScorer(3, 32, cache_path=str(SCORER))
    (p_probs, p_feats), (j_probs, j_feats) = port._apply(images), jax._apply(images)
    np.testing.assert_allclose(p_feats, j_feats, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p_probs, j_probs, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.inception_score(images), jax.inception_score(images), rtol=1e-4)
    np.testing.assert_allclose(port.fid(images[:32], images[32:]), jax.fid(images[:32], images[32:]),
                               rtol=1e-3)
    assert port.sanity_check(images, labels) == jax.sanity_check(images, labels)


def test_scorer_batches_do_not_change_scores(test_images):
    """``_apply`` in batches of 2500 and of 16 (batch norm uses each batch's
    statistics, so the batch size is part of the result): the JAX scorer
    does the same, and this pins the port's batching to it."""
    images, _ = test_images
    port = TrainedScorer(3, 32, cache_path=str(SCORER), device="cpu")
    jax = JaxScorer(3, 32, cache_path=str(SCORER))
    np.testing.assert_allclose(port._apply(images, batch_size=16)[1], jax._apply(images, batch_size=16)[1],
                               rtol=1e-5, atol=1e-5)


def test_fit_equals_jax(tmp_path):
    """256 images, 1 epoch, batch 64, dim 8, seed 5: 4 TF-Adam steps at lr
    1e-3 from the same init in the same batch order.  Parameters agree
    within ``adam_mismatches`` at atol 1e-5 (Adam divides by sqrt(v), so
    an element whose gradient is near zero amplifies rounding); the conv
    biases before the batch norms have zero gradient in exact arithmetic
    and may differ by the 2 * lr per step of a sign flip.  The fitted
    cache is JAX-readable."""
    x, y = synthetic_images(256, 3, 32, seed=11)
    port = TrainedScorer(3, 32, dim=8, cache_path=str(tmp_path / "port.npz"), device="cpu")
    jax = JaxScorer(3, 32, dim=8)
    acc_p = port.fit(x, y, epochs=1, batch_size=64, seed=5)
    acc_j = jax.fit(x, y, epochs=1, batch_size=64, seed=5)
    assert acc_p == pytest.approx(acc_j, abs=1 / 64)
    got = to_jax_params(port.params)
    want = {k: np.asarray(v) for k, v in jax.params.items()}
    assert not adam_mismatches(got, want, lr=1e-3, n_updates=4, atol=1e-5,
                               zero_grad=["Scorer.C2.Biases", "Scorer.C3.Biases"])
    cached = jax_load_checkpoint(str(tmp_path / "port.npz"))
    for k, v in got.items():
        np.testing.assert_array_equal(cached[k], v, err_msg=k)


def test_pick_scorer_fits_once_and_caches(tmp_path):
    x, y = synthetic_images(256, 3, 32, seed=2)
    scorer = pick_scorer(3, 32, str(tmp_path), train_data=(x, y), device="cpu")
    assert (tmp_path / "scorer.npz").exists() and scorer.comparable is False
    again = pick_scorer(3, 32, str(tmp_path), train_data=None, device="cpu")
    for k, v in scorer.params.items():
        assert np.array_equal(again.params[k].numpy(), v.numpy()), k
    assert set(load_checkpoint(str(tmp_path / "scorer.npz"))) == set(scorer.params)


def test_pick_scorer_refuses_when_inception_2015_is_present(tmp_path, monkeypatch):
    """Where the JAX package finds an Inception-2015 weight file, the port
    scores with Inception-2015 too: a file that is not a GraphDef raises
    the JAX package's error, and nothing falls back to the TrainedScorer
    (routing with a real graph: tests/test_torch_inception2015.py)."""
    pb = tmp_path / "classify_image_graph_def.pb"
    pb.write_bytes(b"graph")
    monkeypatch.setenv("CTGAN_INCEPTION_PB", str(pb))
    with pytest.raises(ValueError, match="wire type") as jax_err:
        jax_common.pick_scorer(3, 32, str(tmp_path))
    with pytest.raises(ValueError, match="wire type") as port_err:
        pick_scorer(3, 32, str(tmp_path), device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    assert not (tmp_path / "scorer.npz").exists()


def test_apply_needs_params():
    with pytest.raises(RuntimeError, match="fit"):
        TrainedScorer(3, 32, device="cpu").probs(np.zeros((2, 3072), np.uint8))


def test_find_inception_file_searches_the_jax_locations():
    """The same four default locations as the JAX package, in its order."""
    assert port_inception2015._DEFAULT_LOCATIONS == inception2015._DEFAULT_LOCATIONS
    assert common.find_inception_file is port_inception2015.find_inception_file


@pytest.mark.parametrize("name", ["classify_image_graph_def.pb", "inception-2015-12-05.tgz"])
def test_pick_scorer_refuses_a_weights_file_in_the_working_directory(name, tmp_path, monkeypatch):
    """With ``weights/<file>`` under the working directory the JAX package
    scores with Inception-2015, so the port finds the same file and loads
    it: one that is not a graph raises the JAX package's error type."""
    monkeypatch.delenv("CTGAN_INCEPTION_PB", raising=False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "weights").mkdir()
    (tmp_path / "weights" / name).write_bytes(b"graph")
    found = find_inception_file()
    assert found is not None and found == inception2015.find_inception_file()
    with pytest.raises(Exception) as jax_err:
        jax_common.pick_scorer(3, 32, str(tmp_path))
    with pytest.raises(type(jax_err.value)):
        pick_scorer(3, 32, str(tmp_path), device="cpu")
    assert not (tmp_path / "scorer.npz").exists()
