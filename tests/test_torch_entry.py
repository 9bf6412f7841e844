"""``ctgan_tpu_torch.entry`` against ``__graft_entry__.py`` on the CPU.

* ``entry(device="cpu")``: the flagship's fresh parameters (equal to the
  JAX entry's, exactly), its inputs (equal), and the forward, G at dim 128
  then D over real‖fake, against the JAX entry's ``fn`` with JAX's masks
  injected (``tests/torch_parity.py``): rtol 1e-4, atol 1e-5, as
  ``tests/test_torch_models.py`` holds the flagship's D.
* ``dryrun_multichip(2 | 4, device="cpu")``: gloo ranks spawned by the
  port's launcher; the 4-rank run is ``data 2 x model 2`` and adds the
  per-device SPMD step.  Every metric finite and equal over the ranks, and
  the mesh step equal to the same iteration in one process
  (``dryrun_step``) within ``tests/test_torch_parallel.py``'s metric
  bounds (rtol 1e-4, atol 2 lr per update).
* The launcher: a rank that raises, or one that hangs, ends the group and
  the call raises within the group's timeout; on the card too few visible
  cards raise before anything starts.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

import jax
import torch

import __graft_entry__ as graft
from ctgan_tpu.models import resnet_cifar as jax_resnet

from ctgan_tpu_torch.bridge import from_jax_params
from ctgan_tpu_torch.entry import dryrun_multichip, dryrun_step, entry, mesh_shape
from ctgan_tpu_torch.parallel.launch import run_ranks

import torch_entry_workers as workers
from torch_parity import JaxDraws


def test_entry_equals_the_jax_entry(monkeypatch):
    draws = JaxDraws(monkeypatch, model=jax_resnet)
    jfn, (jparams, jnoise, jlabels, jreal, key) = graft.entry()
    for drawn in (draws.dropouts, draws.noises, *draws.stream_keys.values()):
        drawn.clear()  # the draws of the JAX entry's init trace
    want = jfn(jparams, jnoise, jlabels, jreal, key)
    fn, (params, noise, labels, real, _) = entry(device="cpu")
    ref = from_jax_params({k: np.asarray(v) for k, v in jparams.items()})
    assert list(params) == list(ref)
    for k, v in ref.items():
        assert torch.equal(params[k], v), k
    np.testing.assert_array_equal(noise.numpy(), np.asarray(jnoise))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    np.testing.assert_array_equal(real.numpy(), np.asarray(jreal))
    assert len(draws.dropouts) == 3
    rand = draws.injected()
    with torch.no_grad():
        got = fn(params, noise, labels, real, rand)
    assert rand.exhausted()
    for g, w, shape in zip(got, want, ((16,), (16, 10))):
        assert tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_entry_masks_come_from_the_provider():
    """Two calls draw two sets of masks (the provider's next slots); a fresh
    ``entry`` repeats the first."""
    fn, args = entry(device="cpu")
    with torch.no_grad():
        first, second = fn(*args), fn(*args)
        again = entry(device="cpu")[0](*entry(device="cpu")[1])
    assert not torch.equal(first[0], second[0])
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu_equals_one_process(n):
    from test_torch_parallel import FLAGSHIP_LR

    t0 = time.monotonic()
    out = dryrun_multichip(n, device="cpu")
    assert out["mesh"] == mesh_shape(n) == ((n, 1) if n == 2 else (2, 2))
    assert ("spmd" in out) == (n == 4)
    assert out["launches"] == {"dropout_mask": 0, "philox_uniform": 0}  # the CPU draws the plain masks
    want = dryrun_step(n, device="cpu")
    updates = 2  # critic updates; step 0 drops G's
    for mode in ("step", "spmd") if n == 4 else ("step",):
        assert {"disc_cost", "gen_cost", "ct", "gp", "acgan"} <= set(out[mode])
        assert all(np.isfinite(v) for v in out[mode].values())
    assert set(out["step"]) == set(want)
    for k, v in want.items():
        assert np.isclose(out["step"][k], v, rtol=1e-4, atol=2 * FLAGSHIP_LR * updates), (k, out["step"][k], v)
    assert time.monotonic() - t0 < 120


@pytest.mark.parametrize("fn,timeout", [(workers.raise_on_rank, 120.0), (workers.hang_on_rank, 5.0)],
                         ids=["raises", "hangs"])
def test_a_failed_rank_fails_the_call_within_its_timeout(fn, timeout):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="ranks failed") as info:
        run_ranks(2, fn, (1,), backend="gloo", timeout=timeout, join_timeout=10.0)
    assert time.monotonic() - t0 < timeout + 30
    if fn is workers.raise_on_rank:
        assert "fails on purpose" in str(info.value)
    else:
        assert "deadline" in str(info.value)


def test_dryrun_multichip_on_the_card_needs_a_card_per_rank():
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"{n} cards needed, {n - 1} visible"):
        dryrun_multichip(n)
    with pytest.raises(ValueError, match="cuda or cpu"):
        dryrun_multichip(2, device="meta")
