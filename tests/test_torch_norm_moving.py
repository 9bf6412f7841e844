"""Batch norm's moving statistics (``mode="moving"``/``"blend"``,
``update_stats``, ``per_batch_axes``) and ``train.recalibrate_bn`` against
``ctgan_tpu`` on the CPU, on the same seeded inputs and parameters.

Tolerances: the moving statistics within 1e-6 (relative, with an absolute
floor of 1e-6), the normalised outputs within 1e-5, ``stats_iter`` equal.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ctgan_tpu.core import apply_context, init_context
from ctgan_tpu.ops import batchnorm as jax_batchnorm
from ctgan_tpu.ops import linear as jax_linear
from ctgan_tpu.train.recalibrate import recalibrate_bn as jax_recalibrate_bn

from ctgan_tpu_torch.bridge import from_jax_params
from ctgan_tpu_torch.core import Randomness
from ctgan_tpu_torch.ops import batchnorm, linear
from ctgan_tpu_torch.train import recalibrate_bn

import torch_parity  # noqa: F401  (one intra-op thread per test worker)

STATS_TOL, OUT_TOL = 1e-6, 1e-5
NAMES = ("moving_mean", "moving_variance", "stats_iter")


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _batches(shape, n: int = 3, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.normal(1.5 * i, 2.0 + i, size=shape).astype(np.float32) for i in range(n)]


def _assert_stats(got: dict, want: dict, name: str = "BN") -> None:
    for key in NAMES:
        g, w = np.asarray(got[f"{name}.{key}"]), np.asarray(want[f"{name}.{key}"])
        if key == "stats_iter":
            assert float(g) == float(w)
        else:
            np.testing.assert_allclose(g, w, rtol=STATS_TOL, atol=STATS_TOL, err_msg=key)


def _affine(c: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    return rng.normal(1.0, 0.3, c).astype(np.float32), rng.normal(0.0, 0.3, c).astype(np.float32)


def _jax_params(scale, offset, name="BN"):
    return {f"{name}.scale": jnp.asarray(scale), f"{name}.offset": jnp.asarray(offset)}


@pytest.mark.parametrize("shape", [(8, 4, 4, 3), (16, 5)], ids=["nhwc", "features"])
def test_update_stats_blends_cumulatively_as_jax(shape):
    """Three batches with ``update_stats`` from no state: after each, the
    moving statistics and ``stats_iter``, and the batch-normalised output."""
    scale, offset = _affine(shape[-1])
    to_port = _nchw if len(shape) == 4 else torch.from_numpy
    from_port = _nhwc if len(shape) == 4 else (lambda t: t.detach().numpy())
    j_state, p_state = {}, {}
    for x in _batches(shape):
        with apply_context(_jax_params(scale, offset), mutable_state=dict(j_state)) as ctx:
            want = jax_batchnorm("BN", jnp.asarray(x), update_stats=True)
            j_state = dict(ctx.state)
        got, p_state = batchnorm(to_port(x), torch.from_numpy(scale), torch.from_numpy(offset), update_stats=True,
                                 state=p_state, name="BN")
        _assert_stats(p_state, j_state)
        np.testing.assert_allclose(from_port(got), np.asarray(want), rtol=OUT_TOL, atol=OUT_TOL)
    assert float(p_state["BN.stats_iter"]) == 3.0


@pytest.mark.parametrize("mode", ["moving", "blend"])
def test_moving_and_blend_modes_normalise_as_jax(mode):
    """The statistics of two updates, then a fresh batch normalised by them
    (``moving``) or by ``1/N`` of each example's spatial statistics and
    ``(N-1)/N`` of them (``blend``)."""
    shape = (6, 5, 5, 4)
    scale, offset = _affine(4, seed=2)
    j_state, p_state = {}, {}
    for x in _batches(shape, 2, seed=3):
        with apply_context(_jax_params(scale, offset), mutable_state=dict(j_state)) as ctx:
            jax_batchnorm("BN", jnp.asarray(x), update_stats=True)
            j_state = dict(ctx.state)
        _, p_state = batchnorm(_nchw(x), torch.from_numpy(scale), torch.from_numpy(offset), update_stats=True,
                               state=p_state, name="BN")
    x = np.random.default_rng(9).normal(0.5, 1.5, size=shape).astype(np.float32)
    with apply_context(_jax_params(scale, offset), mutable_state=dict(j_state)):
        want = jax_batchnorm("BN", jnp.asarray(x), mode=mode)
    got = batchnorm(_nchw(x), torch.from_numpy(scale), torch.from_numpy(offset), mode=mode, state=p_state,
                    name="BN")
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=OUT_TOL, atol=OUT_TOL)


def test_moving_mode_without_state_starts_at_zero_mean_unit_variance():
    x = np.random.default_rng(4).normal(size=(3, 2, 2, 2)).astype(np.float32)
    with init_context(seed=0):
        want = jax_batchnorm("BN", jnp.asarray(x), mode="moving")
    got = batchnorm(_nchw(x), torch.ones(2), torch.zeros(2), mode="moving", state={}, name="BN")
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=OUT_TOL, atol=OUT_TOL)
    with pytest.raises(ValueError, match="blend"):
        batchnorm(torch.zeros(3, 2), torch.ones(2), torch.zeros(2), mode="blend", state={}, name="BN")
    with pytest.raises(ValueError, match="name"):
        batchnorm(torch.zeros(3, 2), torch.ones(2), torch.zeros(2), mode="moving", state={})


def test_per_batch_axes_match_jax():
    """Each example's statistics over its spatial axes (JAX's NHWC (1, 2),
    the port's NCHW (2, 3)), in fp32."""
    x = np.random.default_rng(5).normal(2.0, 3.0, size=(4, 3, 3, 6)).astype(np.float32)
    scale, offset = _affine(6, seed=6)
    with apply_context(_jax_params(scale, offset)):
        want = jax_batchnorm("BN", jnp.asarray(x), per_batch_axes=(1, 2))
    got = batchnorm(_nchw(x), torch.from_numpy(scale), torch.from_numpy(offset), per_batch_axes=(2, 3))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=OUT_TOL, atol=OUT_TOL)


# --------------------------------------------------------------- recalibrate_bn

def _jax_model(x, update_stats=False, mode="batch"):
    """``tests/test_recalibrate.py``'s model: a linear layer and a batch norm."""
    h = jax_linear("M.L", 8, 8, x)
    return jax_batchnorm("M.BN", h, mode=mode, update_stats=update_stats)


def _port_model(params, x, bn_state=None, rand=None, *, update_stats=False, mode="batch"):
    h = linear(x, params["M.L.W"], params["M.L.b"])
    return batchnorm(h, params["M.BN.scale"], params["M.BN.offset"], mode=mode, update_stats=update_stats,
                     state=bn_state, name="M.BN")


@pytest.mark.parametrize("reset", [True, False])
def test_recalibrate_bn_matches_jax(reset):
    """Five batches of 8 through the linear layer and the batch norm, from
    empty statistics (``reset``) or on from a first sweep's; then a moving-mode
    evaluation."""
    data = np.random.default_rng(0).normal(3.0, 2.0, size=(40, 8)).astype(np.float32)
    with init_context(seed=0) as ctx:
        _jax_model(jnp.asarray(data[:4]))
    jparams = dict(ctx.params)
    params = from_jax_params({k: np.asarray(v) for k, v in jparams.items()})
    batches = [data[i:i + 8] for i in range(0, 40, 8)]
    j_start = p_start = None
    if not reset:
        j_start = jax_recalibrate_bn(jparams, lambda b: _jax_model(b, update_stats=True),
                                     [jnp.asarray(b) for b in batches[:2]], jax.random.PRNGKey(1))
        p_start = recalibrate_bn(params, lambda p, b, s, r: _port_model(p, b, s, r, update_stats=True)[1],
                                 [torch.from_numpy(b) for b in batches[:2]], Randomness(1, "cpu"))
    want = jax_recalibrate_bn(jparams, lambda b: _jax_model(b, update_stats=True),
                              [jnp.asarray(b) for b in batches], jax.random.PRNGKey(0), reset=reset, state=j_start)
    got = recalibrate_bn(params, lambda p, b, s, r: _port_model(p, b, s, r, update_stats=True)[1],
                         [torch.from_numpy(b) for b in batches], Randomness(0, "cpu"), reset=reset, state=p_start)
    _assert_stats(got, want, "M.BN")
    assert float(got["M.BN.stats_iter"]) == (5.0 if reset else 7.0)
    with apply_context(jparams, mutable_state=dict(want)):
        want_out = _jax_model(jnp.asarray(data[:8]), mode="moving")
    got_out = _port_model(params, torch.from_numpy(data[:8]), got, mode="moving")
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(want_out), rtol=OUT_TOL, atol=OUT_TOL)
