"""The 64 px "Good" ResNet of ``ctgan_tpu_torch`` (``models/good64.py``)
against ``ctgan_tpu``'s on the CPU: parameter creation, G and D at dim 8
in fp32 and bf16 with JAX's dropout masks injected (tests/torch_parity.py),
and G and D at full width on the JAX run's iteration-13000 checkpoint
``runs/good64_r5/params_latest.npz``.

Tolerances, each relative to the largest magnitude of the reference:

* fp32, port against JAX: 1e-5.  The two sum in other orders (cuDNN-free
  CPU convs on both sides); a dim-8 G or D is about a dozen layers deep.
* bf16, D: the bounds of ``tests/test_torch_bf16.py``, 4 bf16 roundoffs
  (``U = 2**-8``) against JAX's bf16 and 12 against the fp32 port.
* bf16, G: 24 U against both.  G passes through about 24 bf16 roundings
  (the input linear; in each of 4 blocks two norms, two convs, a shortcut
  conv and a sum; the output norm, conv and ``tanh``), and batch norm over
  a batch of 4 carries a rounding that lands the other way in one package
  into every later element, so two correct bf16 runs drift apart by up to
  as much as each drifts from fp32.  Over seeds 1-8 at dim 8: up to 14.62
  U between the packages, 16.56-19.39 U from fp32
  (tests/torch_precision_probe.py).
* Full width, G: absolute 1e-4 on tanh outputs (scale 1).  D's logits at
  keep probability 1: 1e-4 relative.  These catch a wrong row order of
  ``Discriminator.Output.W`` over the NHWC-flattened features, which a
  dim-8 test might not.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ctgan_tpu.core import apply_context, default_tpu_policy, init_context, rng_context, split_params
from ctgan_tpu.models import good64 as jax_good64

from ctgan_tpu_torch.bridge import from_jax_params
from ctgan_tpu_torch.core import default_policy, precision_policy
from ctgan_tpu_torch.models import good64 as port_good64
from ctgan_tpu_torch.utils import load_checkpoint

from torch_parity import InjectedRandomness, JaxDraws

ROOT = Path(__file__).resolve().parents[1]
JAX_PARAMS = ROOT / "runs" / "good64_r5" / "params_latest.npz"
DIM, BATCH = 8, 4
U = 2.0 ** -8
KP = port_good64.KP


@pytest.fixture(autouse=True)
def _fp32_after():
    yield
    default_policy(False)
    default_tpu_policy(False)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _max_dev(got, want) -> float:
    """Largest deviation over the largest magnitude of ``want``."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@functools.lru_cache(maxsize=None)
def jax_params(dim: int, mode: str, seed: int = 0) -> tuple[dict, dict]:
    """(gen, disc) params as the JAX 64 px app creates them."""
    with init_context(seed=seed) as ctx:
        with rng_context(jax.random.PRNGKey(seed)):
            jax_good64.good64_discriminator(jax_good64.good64_generator(2, dim=dim), dim, mode=mode)
    gen, disc, rest = split_params(ctx.params, "Generator", "Discriminator")
    assert not rest
    return gen, disc


def _port(params: dict) -> dict:
    return from_jax_params({k: np.asarray(v) for k, v in params.items()})


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    real = rng.uniform(-1, 1, size=(BATCH, 3 * 64 * 64)).astype(np.float32)
    noise = rng.normal(size=(BATCH, 128)).astype(np.float32)
    return real, noise


@pytest.mark.parametrize("mode", ["wgan-ct", "wgan-gp"])
def test_init_params_match_jax(mode):
    """Names, shapes and values of the JAX package's fresh parameters:
    layer norms in D under wgan-ct, batch norms otherwise (the same
    ``offset``/``scale`` names)."""
    gen, disc = jax_params(DIM, mode, seed=4)
    ours = port_good64.init_params(DIM, mode, seed=4)
    want = {**gen, **disc}
    assert list(ours) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(ours[k], np.asarray(v), err_msg=k)
    assert ours["Discriminator.Output.W"].shape == (4 * 4 * 8 * DIM, 1)


def _jax_generator(gen, noise):
    with rng_context(jax.random.PRNGKey(0)), apply_context(gen):
        return jax_good64.good64_generator(len(noise), jnp.asarray(noise), dim=DIM)


def test_generator_matches_jax(batch):
    gen, _ = jax_params(DIM, "wgan-ct", seed=1)
    _, noise = batch
    want = _jax_generator(gen, noise)
    got = port_good64.generator(_port(gen), BATCH, None, dim=DIM, noise=torch.from_numpy(noise))
    assert got.shape == (BATCH, 3 * 64 * 64) and got.dtype == torch.float32
    assert _max_dev(got, want) <= 1e-5


def _jax_discriminator(disc, x, mode, kps):
    with apply_context(disc):
        return jax_good64.good64_discriminator(jnp.asarray(x), DIM, *kps, mode=mode)


@pytest.mark.parametrize("mode,kps,fuse_meanpool", [
    ("wgan-ct", KP, True), ("wgan-ct", (1.0, 1.0, 1.0), False), ("wgan-gp", KP, True),
    ("lsgan", (1.0, 1.0, 1.0), True),
])
def test_discriminator_matches_jax(batch, mode, kps, fuse_meanpool, monkeypatch):
    """Logits and features (the NHWC flattening of JAX's) against the JAX
    D with the same masks, with layer norm (wgan-ct) and batch norm, the
    fused and the plain mean-pool convs."""
    _, disc = jax_params(DIM, mode, seed=2)
    draws = JaxDraws(monkeypatch, fuse_meanpool=fuse_meanpool, model=jax_good64)
    real, _ = batch
    want = _jax_discriminator(disc, real, mode, kps)
    assert len(draws.dropouts) == (3 if kps == KP else 0)
    rand = InjectedRandomness(masks=draws.masks())
    got = port_good64.discriminator(_port(disc), torch.from_numpy(real), rand, dim=DIM, kps=kps,
                                    mode=mode, fuse_meanpool=fuse_meanpool)
    assert rand.exhausted()
    assert got[0].shape == (BATCH,) and got[1].shape == (BATCH, 4 * 4 * 8 * DIM)
    for g, w in zip(got, want):
        assert _max_dev(g, w) <= 1e-5


def test_generator_bf16_matches_jax_and_fp32(batch):
    """G's bf16 output against JAX's bf16 G and the fp32 port's (24 U
    each, on tanh outputs whose scale is about 1; see the module's
    docstring)."""
    gen, _ = jax_params(DIM, "wgan-ct", seed=1)
    _, noise = batch
    default_tpu_policy(True)
    want = _jax_generator(gen, noise)
    run = lambda: port_good64.generator(_port(gen), BATCH, None, dim=DIM, noise=torch.from_numpy(noise))
    with precision_policy("bfloat16"):
        got = run()
    fp32 = run()
    assert str(want.dtype) == "bfloat16" and got.dtype == torch.bfloat16 and fp32.dtype == torch.float32
    assert _max_dev(got, want) <= 24 * U
    assert _max_dev(got, fp32) <= 24 * U


@pytest.mark.parametrize("mode", ["wgan-ct", "wgan-gp"])
def test_discriminator_bf16_matches_jax_and_fp32(batch, mode, monkeypatch):
    _, disc = jax_params(DIM, mode, seed=2)
    draws = JaxDraws(monkeypatch, model=jax_good64)
    real, _ = batch
    default_tpu_policy(True)
    want = _jax_discriminator(disc, real, mode, KP)
    masks = draws.masks()
    run = lambda: port_good64.discriminator(_port(disc), torch.from_numpy(real), InjectedRandomness(masks=masks),
                                            dim=DIM, mode=mode)
    with precision_policy("bfloat16"):
        got = run()
    fp32 = run()
    for g, w, f in zip(got, want, fp32):
        assert str(w.dtype) == "bfloat16" and g.dtype == torch.bfloat16 and f.dtype == torch.float32
        assert _max_dev(g, w) <= 4 * U
        assert _max_dev(g, f) <= 12 * U


def test_zero_grad_params_name_real_parameters():
    names = set(port_good64.init_params(DIM))
    for mode in ("wgan-ct", "dcgan"):
        listed = port_good64.zero_grad_params(mode)
        assert set(listed) <= names
    assert "Discriminator.Output.b" in port_good64.zero_grad_params("wgan-gp")
    assert "Discriminator.Output.b" not in port_good64.zero_grad_params("lsgan")


@pytest.fixture(scope="module")
def checkpoint():
    blob = load_checkpoint(str(JAX_PARAMS))
    assert blob["iteration"] == 13000
    return blob["params"]["gen_params"], blob["params"]["disc_params"]


def test_full_width_checkpoint_matches_jax(checkpoint):
    """The JAX run's G and D (dim 64) on 8 noise rows: G within 1e-4, D's
    logits at keep probability 1 within 1e-4 of their scale, and its
    features equal JAX's NHWC flattening."""
    gen, disc = checkpoint
    noise = np.random.default_rng(0).standard_normal((8, 128), dtype=np.float32)
    with rng_context(jax.random.PRNGKey(0)), apply_context({k: jnp.asarray(v) for k, v in gen.items()}):
        want_x = jax_good64.good64_generator(8, jnp.asarray(noise), dim=64)
    with apply_context({k: jnp.asarray(v) for k, v in disc.items()}):
        want_d, want_f = jax_good64.good64_discriminator(want_x, 64, 1.0, 1.0, 1.0)
    with torch.no_grad():
        x = port_good64.generator(from_jax_params(gen), 8, None, noise=torch.from_numpy(noise))
        d, f = port_good64.discriminator(from_jax_params(disc), torch.from_numpy(np.array(want_x)), None,
                                         kps=(1.0, 1.0, 1.0))
    assert float(np.max(np.abs(x.numpy() - np.asarray(want_x)))) <= 1e-4
    assert _max_dev(d, want_d) <= 1e-4
    assert _max_dev(f, want_f) <= 1e-4
    # the NCHW flattening instead would put other rows of Output.W against the features
    with torch.no_grad():
        wrong = f.reshape(8, 4, 4, 512).permute(0, 3, 1, 2).reshape(8, -1) @ torch.from_numpy(
            np.asarray(disc["Discriminator.Output.W"]))
    assert _max_dev(wrong[:, 0] + float(disc["Discriminator.Output.b"][0]), want_d) > 1e-2


def jax_checkpoint_scores(n: int = 1000, batch: int = 100) -> tuple[float, float]:
    """The JAX package's IS and FID of the good64_r5 checkpoint as
    ``chip_smoke.py``'s good64_checkpoint phase scores the port: G in fp32
    on ``np.random.default_rng(0).standard_normal((n, 128))`` in batches of
    ``batch`` (batch statistics), images ``int32((x + 1) * 255 / 2)``, the
    committed ``runs/good64_r5/scorer.npz``, FID against the first ``n``
    images of ``synthetic_images(4096, 3, 64, seed=0)``."""
    from ctgan_tpu.data.synthetic import synthetic_images
    from ctgan_tpu.eval.scorer import TrainedScorer

    blob = load_checkpoint(str(JAX_PARAMS))
    gen = {k: jnp.asarray(v) for k, v in blob["params"]["gen_params"].items()}
    noise = np.random.default_rng(0).standard_normal((n, 128), dtype=np.float32)

    @jax.jit
    def sample(z):
        with rng_context(jax.random.PRNGKey(0)), apply_context(gen):
            return jax_good64.good64_generator(z.shape[0], z, dim=64)

    flat = np.concatenate([np.asarray(sample(jnp.asarray(noise[i:i + batch]))) for i in range(0, n, batch)])
    images = ((flat + 1.0) * (255.0 / 2)).astype(np.int32)
    scorer = TrainedScorer(3, 64, cache_path=str(JAX_PARAMS.parent / "scorer.npz"))
    real = synthetic_images(4096, 3, 64, seed=0)[0][:n]
    return float(scorer.inception_score(images)[0]), float(scorer.fid(real, images))


@pytest.mark.slow
def test_is_ref_pinned_in_chip_smoke():
    """Recomputes the JAX package's IS of the checkpoint (1,000 full-width
    G forwards on the CPU, a few minutes: marked slow) and holds it to
    the ``GOOD64_IS_REF`` that ``chip_smoke.py`` gates the card against."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    is_ref, _ = jax_checkpoint_scores()
    assert abs(is_ref - chip_smoke.GOOD64_IS_REF) <= 1e-4, is_ref


def test_cpu_batchnorm_keeps_its_digits():
    """Channels whose mean is large against their spread: the port's batch
    norms on a CPU tensor (the JAX package's two-pass form) within 1e-5 of
    float64 in fp32."""
    from ctgan_tpu_torch.ops import batchnorm, cond_batchnorm

    rng = np.random.default_rng(0)
    x = torch.from_numpy(100.0 + rng.normal(size=(4, 8, 16, 16)))
    scale, offset = torch.from_numpy(rng.uniform(0.5, 1.5, 8)), torch.from_numpy(rng.normal(size=8))
    labels = torch.tensor([0, 1, 1, 0])
    for fn, args in ((batchnorm, (scale, offset)),
                     (lambda x, s, o: cond_batchnorm(x, labels, s, o), (scale.repeat(2, 1), offset.repeat(2, 1)))):
        want = fn(x, *args)
        got = fn(x.float(), *(a.float() for a in args))
        assert got.dtype == torch.float32
        assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())
