"""The port's parallel training (``ctgan_tpu_torch.parallel``) on the CPU:
groups of 2 and 4 gloo processes (``tests/torch_parallel_workers.py``),
each spawned once for the module, against the port's one-process run and
against the JAX package's sharded steps on the 8 virtual CPU devices of
``tests/conftest.py`` (``tests/test_parallel.py``, ``test_crossreplica_bn.py``).

Tolerances, each with its reason:

* Port over N ranks against the port in one process: rtol 2e-4, atol 2e-5
  (the JAX package's own bound for its sharded step, ``test_parallel.py:92-96``)
  on every parameter and Adam moment, except where a TF-Adam step's sign is
  decided by rounding (``train.optim.adam_mismatches``' rule): the leaves
  whose gradient is zero up to rounding (``zero_grad_params``) may move by
  up to 2 * lr per update anywhere, and any other parameter at no more than
  0.1% of its elements (or one) per update.  Metrics
  rtol 1e-4, and the same absolute bound: the critic's output bias is such
  a leaf, and G's cost is not blind to it.  The ranks' parameters are equal bit for bit.
* Port against JAX: the bounds of the JAX model-axis test
  (``test_parallel.py:141-156``: params rtol 1e-2 / atol 5e-4, which admits
  a first Adam step's sign on a near-zero gradient, metrics 1e-2) for the
  sharded steps of two packages, and its emulation test's metrics bound 1e-3
  for the per-device trainer.
* Batch norm across ranks: rtol 1e-4, atol 1e-5 against one process and
  against JAX's ``axis_name`` batch norm (``test_crossreplica_bn.py``).
* Row segments of the Philox draws: bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from ctgan_tpu.core import apply_context, init_context
from ctgan_tpu.models import dcgan as jax_dcgan
from ctgan_tpu.ops import batchnorm as jax_batchnorm
from ctgan_tpu.parallel import make_mesh as jax_make_mesh
from ctgan_tpu.parallel import make_spmd_trainer as jax_make_spmd_trainer
from ctgan_tpu.parallel import shard_batch as jax_shard_batch
from ctgan_tpu.parallel import shard_params as jax_shard_params
from ctgan_tpu.train import GanConfig as JaxGanConfig
from ctgan_tpu.train import make_gan_trainer

from ctgan_tpu_torch.bridge import state_to_jax
from ctgan_tpu_torch.kernels.dropout import MAX_SEGMENTS, dropout_mask_reference, philox_uniform_reference
from ctgan_tpu_torch.models import dcgan, resnet_cifar
from ctgan_tpu_torch.ops.norm import batchnorm, cond_batchnorm
from ctgan_tpu_torch.parallel import DEFAULT_RULES, param_spec

import torch_parallel_workers as workers
from torch_parity import nhwc_to_nchw

MNIST_BATCH, FLAGSHIP_BATCH, K = 16, 8, 2
ITERS = 2
UPDATES = ITERS * K  # the most Adam updates a leaf takes in a run (D's)
RTOL, ATOL = 2e-4, 2e-5
JAX_RTOL, JAX_ATOL, JAX_METRIC_TOL = 1e-2, 5e-4, 1e-2
SPMD_METRIC_TOL = 1e-3
NORM_RTOL, NORM_ATOL = 1e-4, 1e-5
MNIST_LR, FLAGSHIP_LR = 1e-4, 2e-4

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


# ------------------------------------------------------------------ inputs

def mnist_params(mode: str) -> dict:
    return dcgan.init_params("mnist", workers.MNIST_DIM, mode, seed=0)


def flagship_params() -> dict:
    return resnet_cifar.init_params(resnet_cifar.ResnetCifarConfig(dim_g=workers.FLAGSHIP_DIM,
                                                                   dim_d=workers.FLAGSHIP_DIM), 0)


MNIST_REAL = np.random.default_rng(0).uniform(size=(K, MNIST_BATCH, 784)).astype(np.float32)
JAX_K = 1  # the JAX runs take one critic substep: each program compiles in seconds, not tens
JAX_REAL = MNIST_REAL[:JAX_K]
_rng = np.random.default_rng(1)
FLAGSHIP_REAL = _rng.integers(0, 256, size=(K, FLAGSHIP_BATCH, 3072)).astype(np.uint8)
FLAGSHIP_LABELS = _rng.integers(0, 10, size=(K, FLAGSHIP_BATCH)).astype(np.int64)
NORM_X = np.random.default_rng(2).normal(3.0, 2.0, size=(8, 4, 3, 3)).astype(np.float32)
NORM_LABELS = np.random.default_rng(3).integers(0, 10, size=8)
NORM_SCALE = np.random.default_rng(4).normal(1.0, 0.2, size=(10, 4)).astype(np.float32)
NORM_OFFSET = np.random.default_rng(5).normal(0.0, 0.2, size=(10, 4)).astype(np.float32)
NORM_COT = np.random.default_rng(6).normal(size=NORM_X.shape).astype(np.float32)
JAX_BN_X = np.random.default_rng(0).normal(3.0, 2.0, size=(32, 4)).astype(np.float32)


def _dp_case(flavor: str, mode: str = "wgan-CT", **kw) -> dict:
    """A run of ``workers.train_steps``: the MNIST nets two iterations from
    step 0; the flagship one iteration at step 1 (G's update taken), since
    its G gradient, taken through a critic two updates on, carries the
    critic's rounding-decided Adam steps (TF-Adam with beta1 0: the moment
    is the gradient) beyond the bound."""
    if flavor == "gan":
        return dict(flavor="gan", params=mnist_params(mode), real=MNIST_REAL, mode=mode, iters=ITERS) | kw
    return dict(flavor="acgan", params=flagship_params(), real=FLAGSHIP_REAL, labels=FLAGSHIP_LABELS, iters=1,
                start_step=1) | kw


def _jax_case(draws: list, **kw) -> dict:
    """A run on the JAX side's draws: its one iteration at step 1."""
    return _dp_case("gan", real=JAX_REAL, draws=draws, iters=1, start_step=1, **kw)


DP_CASES = {"gan-wgan-CT": ("gan", "wgan-CT"), "gan-wgan-gp": ("gan", "wgan-gp"), "acgan": ("acgan", "wgan-CT")}
MODEL_CASES = {"gan-wgan-CT": ("gan", "wgan-CT"), "acgan": ("acgan", "wgan-CT")}


# ------------------------------------------------------------------ the JAX side

def _jax_mnist_fns(mode: str = "wgan-CT"):
    gen = lambda n, noise=None: jax_dcgan.mnist_generator(n, noise, dim=workers.MNIST_DIM, mode=mode)
    disc = lambda x: jax_dcgan.mnist_discriminator(x, dim=workers.MNIST_DIM, mode=mode)
    return gen, disc


def _jax_state(init_state, mode: str = "wgan-CT"):
    arrays = {k: jnp.asarray(v) for k, v in mnist_params(mode).items()}
    return init_state({k: v for k, v in arrays.items() if k.startswith("Generator")},
                      {k: v for k, v in arrays.items() if k.startswith("Discriminator")})


def _counts(draws) -> dict:
    return {"masks": len(draws.dropouts), "noises": len(draws.noises), "gp_alpha": len(draws.stream_keys["gp"])}


def _draw_arrays(draws, gp_n: int, order: dict | None = None) -> list[dict]:
    """``JaxDraws``' record of the one iteration as arrays: masks (NCHW
    bool, keep prob), noises, GP alphas at ``gp_n`` rows; ``order`` says
    which entries the iteration drew (``{kind: [index, ...]}``: a program
    traced once draws the same on each call), else all in turn."""
    out = {"masks": [(nhwc_to_nchw(m) if m.ndim == 4 else m, kp) for m, kp in draws.masks()],
           "noises": list(draws.noises),
           "gp_alpha": [np.array(jax.random.uniform(k, (gp_n, 1), jnp.float32)) for k in draws.stream_keys["gp"]]}
    return [{kind: [out[kind][i] for i in order[kind]] for kind in out} if order else out]




def _unfused_order(marks: list[dict]) -> dict:
    """The entries an iteration of one program per substep drew:
    ``marks[j]`` the record's length before substep ``j`` (G, then each
    critic substep) and after the last.  The critic substeps share one
    program, traced at the first: each draws what that trace recorded."""
    programs: dict = {}
    order = {kind: [] for kind in marks[0]}
    for j, (b, a) in enumerate(zip(marks, marks[1:])):
        program = "gen" if j == 0 else "critic"
        if a != b:
            programs[program] = {kind: list(range(b[kind], a[kind])) for kind in a}
        for kind in order:
            order[kind] += programs[program][kind]
    return order


def _at_step_1(state):
    """``state`` at step 1, where G's update is taken: one iteration then
    checks G and D (each program is compiled once)."""
    return type(state)(state.gen_params, state.disc_params, state.gen_opt, state.disc_opt,
                       jnp.ones((), jnp.int32))


def _jax_report(state, metrics: list) -> dict:
    return {"state": {f: {k: np.asarray(v) for k, v in getattr(state, f).items()}
                      for f in ("gen_params", "disc_params")},
            "metrics": [{k: float(v) for k, v in m.items()} for m in metrics]}


def jax_data_axis(monkeypatch) -> tuple[dict, dict]:
    """The JAX trainer's fused step over the 8-device data axis
    (``test_parallel.py::test_sharded_step_matches_single_device``), one
    iteration at step 1, drawing from ``JaxDraws``: (report, the draws as
    global arrays)."""
    from torch_parity import JaxDraws

    draws = JaxDraws(monkeypatch, model=jax_dcgan)
    cfg = JaxGanConfig(mode="wgan-CT", batch_size=MNIST_BATCH, critic_iters=JAX_K, iters=100)
    init_state, step_fn, _, _ = make_gan_trainer(*_jax_mnist_fns(), cfg)
    state = _at_step_1(_jax_state(init_state))
    mesh = jax_make_mesh(data=8, model=1)
    with mesh:
        state = type(state)(jax_shard_params(mesh, state.gen_params), jax_shard_params(mesh, state.disc_params),
                            state.gen_opt, state.disc_opt, state.step)
        batch = jax_shard_batch(mesh, jnp.asarray(JAX_REAL), batch_axis=1)
        state, m = jax.jit(step_fn)(state, batch, jax.random.PRNGKey(1))
    return _jax_report(state, [m]), _draw_arrays(draws, MNIST_BATCH)


def jax_model_axis(monkeypatch) -> tuple[dict, dict]:
    """The JAX trainer over ``data 4 x model 2`` with model-sharded leaves,
    one program per substep (``test_parallel.py::test_model_axis_step_matches_single_device``,
    ``train/unfused.py``), one iteration at step 1.  The critic substeps
    share one program, so both draw the same: the draws are laid out so."""
    from torch_parity import JaxDraws

    draws = JaxDraws(monkeypatch, model=jax_dcgan)
    cfg = JaxGanConfig(mode="wgan-CT", batch_size=MNIST_BATCH, critic_iters=JAX_K, iters=100)
    init_state, step_fn, _, _ = make_gan_trainer(*_jax_mnist_fns(), cfg)
    state = _at_step_1(_jax_state(init_state))
    mesh = jax_make_mesh(data=4, model=2)
    jit_gen, jit_critic = jax.jit(step_fn.gen_substep), jax.jit(step_fn.critic_substep)
    key = jax.random.PRNGKey(2)
    with mesh:
        state = type(state)(jax_shard_params(mesh, state.gen_params), jax_shard_params(mesh, state.disc_params),
                            state.gen_opt, state.disc_opt, state.step)
        assert "model" in str(state.gen_params["Generator.Input.W"].sharding.spec)
        batch = jax_shard_batch(mesh, jnp.asarray(JAX_REAL), batch_axis=1)
        marks = [_counts(draws)]
        state, g_cost = jit_gen(state, key)
        marks.append(_counts(draws))
        for i in range(JAX_K):
            state, m = jit_critic(state, jnp.asarray(i), batch[i], key)
            marks.append(_counts(draws))
        m["gen_cost"] = g_cost
    return _jax_report(state, [m]), _draw_arrays(draws, MNIST_BATCH, _unfused_order(marks))


def jax_spmd(monkeypatch) -> tuple[dict, dict]:
    """The JAX package's ``make_spmd_trainer`` over ``data 2 x model 2``,
    one iteration at step 1.  ``JaxDraws`` fixes every draw of the per-device
    program, so each device draws the same local arrays (a per-device
    draw in which the fold-in of the device index of ``spmd.py:256-266``
    maps every device to the same draws): the port's ranks get them too."""
    from torch_parity import JaxDraws

    draws = JaxDraws(monkeypatch, model=jax_dcgan)
    cfg = JaxGanConfig(mode="wgan-CT", batch_size=MNIST_BATCH, critic_iters=JAX_K, iters=100)
    gen_fn, disc_fn = _jax_mnist_fns()
    arrays = {k: jnp.asarray(v) for k, v in mnist_params("wgan-CT").items()}
    gp = {k: v for k, v in arrays.items() if k.startswith("Generator")}
    dp = {k: v for k, v in arrays.items() if k.startswith("Discriminator")}
    mesh = jax_make_mesh(jax.devices()[:4], data=2, model=2)
    state, step, _ = jax_make_spmd_trainer(gen_fn, disc_fn, cfg, mesh, gp, dp)
    state = type(state)(state.gen_params, state.disc_params, state.gen_opt, state.disc_opt,
                        jax.device_put(jnp.ones((), jnp.int32), state.step.sharding))
    state, m = step(state, jnp.asarray(JAX_REAL), jax.random.PRNGKey(5))
    return _jax_report(state, [m]), _draw_arrays(draws, MNIST_BATCH // 4)


def _jax_bn(x: np.ndarray, sharded: bool) -> tuple[np.ndarray, dict]:
    """JAX's batch norm of ``x`` (``[N, F]``), over the 8-device data axis
    with ``axis_name`` or on one device (``test_crossreplica_bn.py``)."""
    with init_context(seed=0) as ctx:
        jax_batchnorm("BN", jnp.asarray(x))
    params = ctx.params
    if not sharded:
        with apply_context(params):
            return np.asarray(jax_batchnorm("BN", jnp.asarray(x))), params

    def shard_fn(xb):
        with apply_context(params):
            return jax_batchnorm("BN", xb, axis_name="data")

    mesh = jax_make_mesh(data=8, model=1)
    out = jax.shard_map(shard_fn, mesh=mesh, in_specs=JP("data"), out_specs=JP("data"))(jnp.asarray(x))
    return np.asarray(out), params


# ------------------------------------------------------------------ the groups

@pytest.fixture(scope="module")
def jax_runs():
    """The JAX runs and their draws (one monkeypatch each, undone after)."""
    out = {}
    for name, fn in (("data", jax_data_axis), ("model", jax_model_axis), ("spmd", jax_spmd)):
        with pytest.MonkeyPatch.context() as mp:
            out[name] = fn(mp)
    return out


@pytest.fixture(scope="module")
def one_process(jax_runs):
    """The port's one-process runs (no mesh), the references: its own
    draws, and the JAX runs' draws."""
    out = {f"dp:{name}": workers.train_steps(**_dp_case(*case)) for name, case in DP_CASES.items()}
    for axis in ("data", "model"):
        out[f"jax:{axis}"] = workers.train_steps(**_jax_case(jax_runs[axis][1]))
    return out


@pytest.fixture(scope="module")
def groups(jax_runs, tmp_path_factory):
    """Each group spawned once: 2 ranks and 4 ranks, every case of the
    module in it."""
    two = [(f"train_steps:dp:{n}", _dp_case(*c)) for n, c in DP_CASES.items()]
    two += [("norm:plain", dict(x=NORM_X, labels=NORM_LABELS, scale=NORM_SCALE[0], offset=NORM_OFFSET[0],
                                cot=NORM_COT, cond=False)),
            ("norm:cond", dict(x=NORM_X, labels=NORM_LABELS, scale=NORM_SCALE, offset=NORM_OFFSET, cot=NORM_COT,
                               cond=True)),
            ("train_steps:jax:data", _jax_case(jax_runs["data"][1]))]
    four = [("mesh_facts", {})] + [(f"train_steps:dp:{n}", _dp_case(*c)) for n, c in DP_CASES.items()]
    four += [(f"train_steps:model:{n}", _dp_case(*c, model=2)) for n, c in MODEL_CASES.items()]
    four += [("norm:plain", two[3][1]), ("norm:cond", two[4][1]),
             ("norm:jax", dict(x=JAX_BN_X, labels=np.zeros(32, np.int64), scale=np.ones(4, np.float32),
                               offset=np.zeros(4, np.float32), cot=np.ones_like(JAX_BN_X), cond=False)),
             ("train_steps:jax:model", _jax_case(jax_runs["model"][1], model=2)),
             ("spmd_steps:jax:spmd", dict(flavor="gan", params=mnist_params("wgan-CT"), real=JAX_REAL,
                                          draws=jax_runs["spmd"][1], iters=1, start_step=1)),
             ("spmd_steps:acgan", dict(flavor="acgan", params=flagship_params(), real=FLAGSHIP_REAL,
                                       labels=FLAGSHIP_LABELS))]
    tmp = tmp_path_factory.mktemp("groups")
    two, four = workers.run_groups([(2, two, tmp / "two"), (4, four, tmp / "four")])
    return {2: two, 4: four}


# ------------------------------------------------------------------ checks

def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def assert_states_close(got: dict, want: dict, zero_grad: list, step_bound: float, *, rtol=RTOL, atol=ATOL,
                        fields=("gen_params", "disc_params", "gen_opt", "disc_opt"),
                        moment_scale_rtol: float | None = None) -> None:
    """``got`` against ``want`` (trainer states, JAX layout) by the
    module's rules.  ``moment_scale_rtol``: hold the optimiser moments to
    that fraction of each tensor's scale (its largest value, floored at 1%
    of the field's largest) instead, for runs of several iterations, whose
    later gradients the critic's rounding-decided Adam steps move."""
    for field in fields:
        want_leaves = dict(_flat(want[field]))
        got_leaves = dict(_flat(got[field]))
        assert set(got_leaves) == set(want_leaves), field
        floor = 0.01 * max(float(np.abs(w).max()) for w in want_leaves.values())
        for k, w in want_leaves.items():
            g = got_leaves[k]
            assert g.shape == w.shape, (field, k, g.shape, w.shape)
            if field.endswith("_opt") and moment_scale_rtol is not None:
                scale = max(float(np.abs(w).max()), floor)
                assert np.abs(g.astype(np.float64) - w).max() <= moment_scale_rtol * scale, (field, k)
                continue
            if k.split("/")[-1] in zero_grad:
                if field.endswith("_params"):
                    assert np.abs(g.astype(np.float64) - w).max() <= step_bound + atol, (field, k)
                continue
            if field.endswith("_params") and step_bound:
                # a first Adam step on a gradient near zero goes the way rounding says
                apart = ~np.isclose(g, w, rtol=rtol, atol=atol)
                assert np.sum(apart) <= max(1, g.size * UPDATES // 1000), (field, k, int(np.sum(apart)))
                assert np.abs(g.astype(np.float64) - w).max() <= step_bound + atol, (field, k)
                continue
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"{field} {k}")


def assert_metrics_close(got: list, want: list, rtol: float, atol: float = 0.0) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(w) <= set(g)
        for k in w:
            assert np.isclose(g[k], w[k], rtol=rtol, atol=atol), (k, g[k], w[k])


def assert_ranks_equal(results: list, name: str) -> None:
    first = dict(_flat(results[0][name]["state"]))
    for r in results[1:]:
        for k, v in _flat(r[name]["state"]):
            np.testing.assert_array_equal(v, first[k], err_msg=k)


def _zero_grad(flavor: str, mode: str) -> list:
    if flavor == "gan":
        return dcgan.zero_grad_params("mnist", mode)
    return resnet_cifar.zero_grad_params(resnet_cifar.ResnetCifarConfig(dim_g=16, dim_d=16))


def _step_bound(flavor: str) -> float:
    """2 * lr per Adam update of the leaf that moved most: D's updates."""
    return 2 * (MNIST_LR if flavor == "gan" else FLAGSHIP_LR) * UPDATES


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("case", ["shapes", "errors", "param_spec", "effective_specs", "shard_params", "groups"])
def test_mesh(case, groups):
    """The port's counterparts of ``test_parallel.py:27-51``, on the
    4-rank group (data-major ranks) and on the rules."""
    if case == "param_spec":
        # JAX's specs on [in, out] weights, transposed to the port's [out, in]
        assert param_spec("Generator.Input.W", None) == ("model", None)
        assert param_spec("Discriminator.Output.W", None) == (None, "model")
        assert param_spec("Discriminator.2.Conv1.Filters", None) == ()
        assert [r for r, _ in DEFAULT_RULES] == [r".*Generator\.Input\.W$", r".*Generator\.Input\.b$",
                                                 r".*Discriminator\.Output\.W$", r".*\.EmbeddingMatrix$"]
        return
    facts = [g["mesh_facts"] for g in groups[4]]
    if case == "shapes":
        assert [f["2x2"] for f in facts] == [(0, 0), (0, 1), (1, 0), (1, 1)]
        assert [f["4x1"] for f in facts] == [(0, 0), (1, 0), (2, 0), (3, 0)]
        assert all(f["default"] == (4, 1) for f in facts)
    elif case == "errors":
        assert all(f["3x2"] == "mesh 3x2 != 4 devices" for f in facts)
    elif case == "effective_specs":
        assert facts[0]["specs"] == {"Generator.Input.W": ("model", None), "Discriminator.Output.W": ()}
    elif case == "shard_params":
        assert [f["shard"] for f in facts] == [(128, 128), (128, 128), (128, 128), (128, 128)]
        assert [f["shard_value"] for f in facts] == [0.0, 128.0, 0.0, 128.0]
    else:
        assert [f["group_sizes"] for f in facts] == [(2, 2, 4)] * 4


@pytest.mark.parametrize("start_offset", [0, 3])
@pytest.mark.parametrize("n_segments", range(1, MAX_SEGMENTS + 1))
@pytest.mark.parametrize("kind", ["fp32", "bf16", "uniform"])
def test_segment_draws_are_rows_of_the_global_draw(kind, n_segments, start_offset):
    """The plain versions' segment form equals the elements of the global
    draw at those segments, bit for bit, for 1 to 4 segments, with starts
    that are multiples of 8 and starts that are not."""
    seed, shape = 77, (40, 6, 5)
    row = 30
    n = 40 * row
    if kind == "uniform":
        draw = lambda shp, **kw: philox_uniform_reference(seed, shp, 0.25, **kw)
    else:
        dtype = torch.float32 if kind == "fp32" else torch.bfloat16
        draw = lambda shp, **kw: dropout_mask_reference(seed, shp, 0.6, dtype, **kw)
    whole = draw(shape).reshape(-1)
    starts = [start_offset + i * (n // MAX_SEGMENTS) for i in range(n_segments)]
    counts = [row * 2 + (i % 3) for i in range(n_segments)]
    segs = list(zip(starts, counts))
    got = draw((sum(counts),), segments=segs)
    want = torch.cat([whole[a:a + c] for a, c in segs])
    assert torch.equal(got, want)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("cond", [False, True])
def test_batchnorm_across_ranks_equals_one_process(world, cond, groups):
    """Forward and input gradient of (conditional) batch norm over the
    ranks' rows against one process on the whole batch; the scale and
    offset gradients summed over the ranks."""
    name = "norm:cond" if cond else "norm:plain"
    x, cot = torch.tensor(NORM_X, requires_grad=True), torch.from_numpy(NORM_COT)
    scale = torch.tensor(NORM_SCALE if cond else NORM_SCALE[0], requires_grad=True)
    offset = torch.tensor(NORM_OFFSET if cond else NORM_OFFSET[0], requires_grad=True)
    out = cond_batchnorm(x, torch.from_numpy(NORM_LABELS), scale, offset) if cond else batchnorm(x, scale, offset)
    (out * cot).sum().backward()
    results = [g[name] for g in groups[world]]
    np.testing.assert_allclose(np.concatenate([r["out"] for r in results]), out.detach().numpy(),
                               rtol=NORM_RTOL, atol=NORM_ATOL)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in results]), x.grad.numpy(),
                               rtol=NORM_RTOL, atol=NORM_ATOL)
    for key, want in (("dscale", scale.grad), ("doffset", offset.grad)):
        np.testing.assert_allclose(sum(r[key] for r in results), want.numpy(), rtol=NORM_RTOL, atol=NORM_ATOL)


def test_batchnorm_across_ranks_matches_jax_axis_name(groups):
    """4 ranks' batch norm against JAX's ``axis_name="data"`` batch norm
    under ``shard_map`` on 8 devices (``test_crossreplica_bn.py``), on the
    same inputs."""
    want, params = _jax_bn(JAX_BN_X, sharded=True)
    assert {k.split(".")[-1] for k in params} == {"scale", "offset"}
    got = np.concatenate([g["norm:jax"]["out"] for g in groups[4]])
    np.testing.assert_allclose(got, want, rtol=NORM_RTOL, atol=NORM_ATOL)
    np.testing.assert_allclose(got, _jax_bn(JAX_BN_X, sharded=False)[0], rtol=NORM_RTOL, atol=NORM_ATOL)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(DP_CASES))
def test_data_axis_step_equals_one_process(world, case, groups, one_process):
    """The data-axis step (``parallel.data_parallel``, the port's own draws,
    each rank its rows) over 2 and 4 ranks equals the one-process step for
    G, D and Adam state after two iterations; every rank holds the same."""
    flavor, mode = DP_CASES[case]
    name = f"train_steps:dp:{case}"
    want = one_process[f"dp:{case}"]
    assert_ranks_equal(groups[world], name)
    got = groups[world][0][name]
    assert_states_close(got["state"], want["state"], _zero_grad(flavor, mode), _step_bound(flavor))
    assert_metrics_close(got["metrics"], want["metrics"], rtol=1e-4, atol=_step_bound(flavor))


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_axis_step_equals_one_process(case, groups, one_process):
    """``data 2 x model 2``: the rule leaves (G's input projection, D's
    output head) and their Adam moments stored as halves, gathered in each
    substep; the state equals the one-process state."""
    flavor, mode = MODEL_CASES[case]
    name = f"train_steps:model:{case}"
    assert_ranks_equal(groups[4], name)
    got = groups[4][0][name]
    full_w = dict(_flat(got["state"]["gen_params"]))["Generator.Input.W"].shape  # JAX layout [in, out]
    assert got["stored"]["Generator.Input.W"] == (full_w[1] // 2, full_w[0])
    assert_states_close(got["state"], one_process[f"dp:{case}"]["state"], _zero_grad(flavor, mode),
                        _step_bound(flavor))
    assert_metrics_close(got["metrics"], one_process[f"dp:{case}"]["metrics"], rtol=1e-4, atol=_step_bound(flavor))


@pytest.mark.parametrize("axis", ["data", "model"])
def test_sharded_steps_match_jax(axis, jax_runs, groups, one_process):
    """On the JAX package's draws: the port's data-axis step over 2 ranks
    against JAX's fused step over the 8-device data axis
    (``test_parallel.py:66-97``), and its ``data 2 x model 2`` step against
    JAX's ``data 4 x model 2`` step with model-sharded leaves
    (``test_parallel.py:99-156``); each also against the port's one
    process on the same draws."""
    want, _ = jax_runs[axis]
    world = 2 if axis == "data" else 4
    got = groups[world][0][f"train_steps:jax:{axis}"]
    assert_ranks_equal(groups[world], f"train_steps:jax:{axis}")
    assert_states_close(got["state"], want["state"], [], 0.0, rtol=JAX_RTOL, atol=JAX_ATOL,
                        fields=("gen_params", "disc_params"))
    assert_metrics_close(got["metrics"], want["metrics"], rtol=JAX_METRIC_TOL, atol=JAX_METRIC_TOL)
    ref = one_process[f"jax:{axis}"]
    assert_states_close(got["state"], ref["state"], _zero_grad("gan", "wgan-CT"), _step_bound("gan"))
    assert_metrics_close(got["metrics"], ref["metrics"], rtol=1e-4, atol=_step_bound("gan"))


def test_spmd_trainer_matches_jax(jax_runs, groups):
    """``make_spmd_trainer`` (per-device draws, ghost batch norm, the mesh
    mean of gradients and metrics) over ``data 2 x model 2`` against the
    JAX package's ``make_spmd_trainer`` on the same per-device draws."""
    want, _ = jax_runs["spmd"]
    name = "spmd_steps:jax:spmd"
    assert_ranks_equal(groups[4], name)
    got = groups[4][0][name]
    assert got["stored"]["Generator.Input.W"][0] * 2 == dict(_flat(got["state"]["gen_params"]))[
        "Generator.Input.W"].shape[1]
    assert_states_close(got["state"], want["state"], [], 0.0, rtol=JAX_RTOL, atol=JAX_ATOL,
                        fields=("gen_params", "disc_params"))
    assert_metrics_close(got["metrics"], want["metrics"], rtol=SPMD_METRIC_TOL, atol=SPMD_METRIC_TOL)


def test_spmd_trainer_acgan_runs_and_ranks_agree(groups):
    """``flavor="acgan"`` on the flagship at dim 16: two iterations, finite
    metrics, every rank the same state, the rule leaves stored in halves."""
    name = "spmd_steps:acgan"
    assert_ranks_equal(groups[4], name)
    got = groups[4][0][name]
    assert all(np.isfinite(v) for m in got["metrics"] for v in m.values())
    assert set(got["metrics"][-1]) >= {"disc_cost", "ct", "gp", "wgan", "acgan", "gen_cost"}
    full = dict(_flat(got["state"]["gen_params"]))["Generator.Input.W"].shape
    assert got["stored"]["Generator.Input.W"] == (full[1] // 2, full[0])


def test_spmd_trainer_refuses_clip_global_norm():
    from ctgan_tpu_torch.parallel import make_spmd_trainer
    from ctgan_tpu_torch.train import GanConfig

    with pytest.raises(NotImplementedError, match="clip_global_norm"):
        make_spmd_trainer(None, None, GanConfig(clip_global_norm=1.0), None, {}, {})
