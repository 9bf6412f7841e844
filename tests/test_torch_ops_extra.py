"""The rest of the op library against ``ctgan_tpu`` on the CPU: ``conv1d``
(each mask type, weight norm, stride), ``separable_conv2d``,
``centered_softplus``, the orthogonal and uniform inits, the recurrent
cells, ``embedding``, ``mlp``, the KL divergences, minibatch
discrimination, ``lsuv_init`` and the debug probes; and the bridge's
layouts of their parameters.

Each op runs on parameters the JAX package initialised, carried through
``bridge.from_jax_params``, on the same seeded inputs.  Tolerances, fp32:
forwards within 1e-5 of the reference's largest magnitude; for ``gru``,
``conv1d``, ``separable_conv2d`` and minibatch discrimination the gradients
of ``sum(out * cot)`` by the input and by every parameter within 1e-5 of
each reference tensor's largest.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ctgan_tpu import ops as jax_ops
from ctgan_tpu.core import apply_context, init_context
from ctgan_tpu.ops import init as jax_init
from ctgan_tpu.utils import debug as jax_debug

from ctgan_tpu_torch import ops as port_ops
from ctgan_tpu_torch.bridge import from_jax_params, to_jax_params
from ctgan_tpu_torch.ops import init as port_init
from ctgan_tpu_torch.utils import debug as port_debug

import torch_parity  # noqa: F401  (one intra-op thread per test worker)

TOL = 1e-5


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got.astype(np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def _init(fn, seed: int = 0) -> dict:
    """The parameters the JAX op creates when ``fn()`` runs."""
    with init_context(seed=seed) as ctx:
        fn()
    return dict(ctx.params)


def check_against_jax(jax_fn, port_fn, jparams: dict, x: np.ndarray, to_port_x, to_jax_layout) -> None:
    """``jax_fn(params, x)`` against ``port_fn(params, x)`` (the port's
    layouts; ``to_port_x`` makes the port's input of ``x``,
    ``to_jax_layout`` turns the port's output and input gradient into the
    JAX layout): the forward, and the gradients of ``sum(y * cot)`` by ``x``
    and by each parameter (compared in the JAX layout)."""
    want = np.asarray(jax_fn(jparams, jnp.asarray(x)))
    params = {k: v.requires_grad_(True) for k, v in from_jax_params({k: np.asarray(v) for k, v in
                                                                    jparams.items()}).items()}
    xt = to_port_x(x).requires_grad_(True)
    got = to_jax_layout(port_fn(params, xt))
    assert _rel(got, want) <= TOL, _rel(got, want)
    cot = np.random.default_rng(11).normal(size=want.shape).astype(np.float32)
    j_gp, j_gx = jax.grad(lambda p, v: jnp.sum(jax_fn(p, v) * cot), argnums=(0, 1))(jparams, jnp.asarray(x))
    names = list(params)
    g = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), [params[k] for k in names] + [xt])
    port_grads = to_jax_params(dict(zip(names, g[:-1])))
    for k in names:
        assert _rel(port_grads[k], j_gp[k]) <= TOL, (k, _rel(port_grads[k], j_gp[k]))
    gx = to_jax_layout(g[-1])
    assert _rel(gx, j_gx) <= TOL, _rel(gx, j_gx)


def _channels_first(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return torch.movedim(t, 1, -1)


# --------------------------------------------------------------- convolutions

@pytest.mark.parametrize("mask_type,weightnorm,stride", [
    (None, False, 1), (("a", 1), False, 1), (("b", 1), True, 1), (("a", 3), False, 1), (("b", 3), False, 1),
    (None, True, 2),
])
def test_conv1d_matches_jax(mask_type, weightnorm, stride):
    cin, cout, k = (3, 6, 5) if mask_type and mask_type[1] == 3 else (4, 5, 3)
    x = np.random.default_rng(1).normal(size=(2, 9, cin)).astype(np.float32)
    kw = dict(mask_type=mask_type, weightnorm=weightnorm, stride=stride)
    jparams = _init(lambda: jax_ops.conv1d("C", cin, cout, k, jnp.asarray(x), **kw))
    jparams["C.Biases"] = jnp.asarray(np.random.default_rng(2).normal(size=cout).astype(np.float32))
    assert jparams["C.Filters"].shape == (k, cin, cout)

    def jax_fn(p, v):
        with apply_context(p):
            return jax_ops.conv1d("C", cin, cout, k, v, **kw)

    def port_fn(p, v):
        return port_ops.conv1d(v, p["C.Filters"], p["C.Biases"], stride=stride, mask_type=mask_type,
                               g=p.get("C.g"))

    check_against_jax(jax_fn, port_fn, jparams, x, _channels_first, _channels_last)


@pytest.mark.parametrize("mult,stride", [(1, 1), (2, 1), (2, 2)])
def test_separable_conv2d_matches_jax(mult, stride):
    x = np.random.default_rng(3).normal(size=(2, 6, 6, 3)).astype(np.float32)
    kw = dict(depth_multiplier=mult, stride=stride)
    jparams = _init(lambda: jax_ops.separable_conv2d("S", 3, 4, 3, jnp.asarray(x), **kw))
    jparams["S.Biases"] = jnp.asarray(np.random.default_rng(4).normal(size=4).astype(np.float32))
    port = from_jax_params({k: np.asarray(v) for k, v in jparams.items()})
    assert port["S.DepthwiseFilters"].shape == (3, mult, 3, 3) and port["S.PointwiseFilters"].shape == (4, 3 * mult,
                                                                                                        1, 1)

    def jax_fn(p, v):
        with apply_context(p):
            return jax_ops.separable_conv2d("S", 3, 4, 3, v, **kw)

    def port_fn(p, v):
        return port_ops.separable_conv2d(v, p["S.DepthwiseFilters"], p["S.PointwiseFilters"], p["S.Biases"],
                                         stride=stride)

    check_against_jax(jax_fn, port_fn, jparams, x, _channels_first, _channels_last)


def test_bridge_carries_the_new_layouts_both_ways_exactly():
    """A 3-D ``.Filters`` is conv1d's (not a 2-D weight or a 4-D filter), a
    ``.theta`` and an ``.EmbeddingMatrix`` stay as they are, the recurrent
    cells' ``.W`` are linear weights; the way back gives the same bits."""
    rng = np.random.default_rng(5)
    arrays = {"C.Filters": (5, 3, 4), "S.DepthwiseFilters": (3, 3, 2, 2), "S.PointwiseFilters": (1, 1, 4, 6),
              "E.EmbeddingMatrix": (7, 3), "MB.theta": (6, 4, 5), "G.Step.Gates.W": (9, 10),
              "G.Step.Candidate.W": (9, 5), "R.Step.InputToHidden.W": (7, 4), "MB.log_weight_scale": (4, 5)}
    jax_side = {k: rng.normal(size=s).astype(np.float32) for k, s in arrays.items()}
    port = from_jax_params(jax_side)
    assert port["C.Filters"].shape == (4, 3, 5) and port["S.DepthwiseFilters"].shape == (2, 2, 3, 3)
    assert port["S.PointwiseFilters"].shape == (6, 4, 1, 1) and port["G.Step.Gates.W"].shape == (10, 9)
    assert torch.equal(port["MB.theta"], torch.from_numpy(jax_side["MB.theta"]))
    assert torch.equal(port["E.EmbeddingMatrix"], torch.from_numpy(jax_side["E.EmbeddingMatrix"]))
    back = to_jax_params(port)
    for k, v in jax_side.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(ValueError, match="3-D"):
        from_jax_params({"X.Filters": np.zeros((2, 2), np.float32)})


# --------------------------------------------------------------- activations and inits

def test_centered_softplus_matches_jax():
    x = np.random.default_rng(6).normal(scale=4.0, size=(7, 5)).astype(np.float32)
    got = port_ops.centered_softplus(torch.from_numpy(x))
    assert _rel(got, jax_ops.centered_softplus(jnp.asarray(x))) <= 1e-6
    assert float(port_ops.centered_softplus(torch.zeros(()))) == float(jax_ops.centered_softplus(jnp.zeros(())))


@pytest.mark.parametrize("shape", [(6, 6), (4, 9), (9, 4), (3, 2, 5)])
def test_orthogonal_init_is_orthogonal(shape):
    """The port's own draw: its shape, orthonormal rows or columns (whichever
    are fewer), and the JAX package's numbers from the same generator."""
    w = port_init.orthogonal(np.random.default_rng(7), shape)
    assert w.shape == shape and w.dtype == np.float32
    flat = w.reshape(shape[0], -1).astype(np.float64)
    gram = flat @ flat.T if flat.shape[0] <= flat.shape[1] else flat.T @ flat
    np.testing.assert_allclose(gram, np.eye(len(gram)), atol=1e-6)
    np.testing.assert_array_equal(w, jax_init.orthogonal(np.random.default_rng(7), shape))


@pytest.mark.parametrize("scheme,gain", [("orthogonal", 1.0), ("orthogonal", 0.5), (("uniform", 0.1), 1.0),
                                         ("he", 2.0)])
def test_linear_initializer_menu_with_gain_equals_jax(scheme, gain):
    a, b = np.random.default_rng(8), np.random.default_rng(8)
    np.testing.assert_array_equal(port_init.linear_initializer(a, 5, 5, scheme, gain),
                                  jax_init.linear_initializer(b, 5, 5, scheme, gain))


# --------------------------------------------------------------- recurrent cells, embedding, MLP

T, D, H = 4, 3, 5


def test_gru_matches_jax_forward_and_gradients():
    x = np.random.default_rng(9).normal(size=(2, T, D)).astype(np.float32)
    jparams = _init(lambda: jax_ops.gru("G", D, H, jnp.asarray(x)))
    jparams = {k: v + 0.1 if k.endswith(".b") or k.endswith(".h0") else v for k, v in jparams.items()}

    def jax_fn(p, v):
        with apply_context(p):
            return jax_ops.gru("G", D, H, v)

    check_against_jax(jax_fn, lambda p, v: port_ops.gru(p, "G", v), jparams, x, torch.from_numpy, lambda t: t)


def test_rnn_and_steps_match_jax():
    x = np.random.default_rng(10).normal(size=(2, T, D)).astype(np.float32)
    h0 = np.random.default_rng(11).normal(size=(2, H)).astype(np.float32)
    jparams = _init(lambda: jax_ops.rnn("R", D, H, jnp.asarray(x)))
    port = from_jax_params({k: np.asarray(v) for k, v in jparams.items()})
    with apply_context(jparams):
        want = jax_ops.rnn("R", D, H, jnp.asarray(x), jnp.asarray(h0))
        want_step = jax_ops.rnn_step("R.Step", D, H, jnp.asarray(x[:, 0]), jnp.asarray(h0))
    assert _rel(port_ops.rnn(port, "R", torch.from_numpy(x), torch.from_numpy(h0)), want) <= TOL
    assert _rel(port_ops.rnn_step(port, "R.Step", torch.from_numpy(x[:, 0]), torch.from_numpy(h0)),
                want_step) <= TOL
    gparams = _init(lambda: jax_ops.gru_step("S", D, H, jnp.asarray(x[:, 0]), jnp.asarray(h0)))
    with apply_context(gparams):
        want = jax_ops.gru_step("S", D, H, jnp.asarray(x[:, 0]), jnp.asarray(h0))
    got = port_ops.gru_step(from_jax_params({k: np.asarray(v) for k, v in gparams.items()}), "S",
                            torch.from_numpy(x[:, 0]), torch.from_numpy(h0))
    assert _rel(got, want) <= TOL


def test_embedding_and_mlp_match_jax():
    idx = np.array([0, 3, 3, 6])
    jparams = _init(lambda: jax_ops.embedding("E", 7, 4, jnp.asarray(idx)))
    with apply_context(jparams):
        want = jax_ops.embedding("E", 7, 4, jnp.asarray(idx))
    port = from_jax_params({k: np.asarray(v) for k, v in jparams.items()})
    assert torch.equal(port_ops.embedding(port["E.EmbeddingMatrix"], torch.from_numpy(idx)),
                       torch.from_numpy(np.asarray(want)))

    x = np.random.default_rng(12).normal(size=(5, 6)).astype(np.float32)
    jparams = _init(lambda: jax_ops.mlp("M", 6, 8, 3, 4, jnp.asarray(x)))
    with apply_context(jparams):
        want = jax_ops.mlp("M", 6, 8, 3, 4, jnp.asarray(x))
    port = from_jax_params({k: np.asarray(v) for k, v in jparams.items()})
    assert _rel(port_ops.mlp(port, "M", torch.from_numpy(x), 4), want) <= TOL
    with pytest.raises(ValueError, match="n_layers"):
        port_ops.mlp(port, "M", torch.from_numpy(x), 2)


def test_kl_divergences_match_jax():
    rng = np.random.default_rng(13)
    mu1, lv1, mu2, lv2 = (rng.normal(size=(4, 3)).astype(np.float32) for _ in range(4))
    t = lambda a: torch.from_numpy(a)
    assert _rel(port_ops.kl_gaussian_gaussian(t(mu1), t(lv1), t(mu2), t(lv2)),
                jax_ops.kl_gaussian_gaussian(mu1, lv1, mu2, lv2)) <= 1e-6
    assert _rel(port_ops.kl_unit_gaussian(t(mu1), t(lv1)), jax_ops.kl_unit_gaussian(mu1, lv1)) <= 1e-6


# --------------------------------------------------------------- minibatch discrimination, LSUV

def test_minibatch_discrimination_matches_jax():
    x = np.random.default_rng(14).normal(size=(6, 5)).astype(np.float32)
    jparams = _init(lambda: jax_ops.minibatch_discrimination("MB", 5, 4, jnp.asarray(x), dim_per_kernel=3))
    jparams["MB.log_weight_scale"] = jnp.asarray(np.random.default_rng(15).normal(scale=0.3, size=(4, 3))
                                                 .astype(np.float32))

    def jax_fn(p, v):
        with apply_context(p):
            return jax_ops.minibatch_discrimination("MB", 5, 4, v, dim_per_kernel=3)

    def port_fn(p, v):
        return port_ops.minibatch_discrimination(v, p["MB.theta"], p["MB.log_weight_scale"], p["MB.b"])

    check_against_jax(jax_fn, port_fn, jparams, x, torch.from_numpy, lambda t: t)


def test_lsuv_init_reaches_unit_variance_on_the_same_layers_as_jax():
    """Two linear layers with a ReLU between: each rescaled in turn until
    its output's variance is within ``tol`` of 1, in JAX and in the port;
    the rescaled weights agree (1e-5)."""
    x = np.random.default_rng(16).normal(size=(64, 10)).astype(np.float32)
    names = ["L1.W", "L2.W"]

    def jax_forward(name):
        h = jax_ops.linear("L1", 10, 12, jnp.asarray(x))
        return h if name == "L1.W" else jax_ops.linear("L2", 12, 6, jax.nn.relu(h))

    jparams = _init(lambda: jax_forward("L2.W"))
    jparams = {k: v * 3.0 for k, v in jparams.items()}
    want = jax_ops.lsuv_init(jparams, jax_forward, names, jax.random.PRNGKey(0), tol=0.01)

    def port_forward(p, name, rand):
        h = port_ops.linear(torch.from_numpy(x), p["L1.W"], p["L1.b"])
        return h if name == "L1.W" else port_ops.linear(torch.relu(h), p["L2.W"], p["L2.b"])

    port = from_jax_params({k: np.asarray(v) for k, v in jparams.items()})
    got = port_ops.lsuv_init(port, port_forward, names, tol=0.01)
    for name in names:
        assert abs(float(port_forward(got, name, None).var(unbiased=False)) - 1.0) < 0.01, name
        with apply_context(want):
            assert abs(float(jnp.var(jax_forward(name))) - 1.0) < 0.01, name
    back = to_jax_params(got)
    for k, v in want.items():
        assert _rel(back[k], v) <= TOL, k


# --------------------------------------------------------------- debug probes

def test_debug_probes_match_jax(capsys):
    x = np.random.default_rng(17).normal(1.0, 2.0, size=(4, 6)).astype(np.float32)
    want = jax_debug.stats(jnp.asarray(x))
    got = port_debug.stats(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-6, k
    port_debug.print_stats("x", torch.from_numpy(x))
    s = {k: float(v) for k, v in want.items()}
    assert capsys.readouterr().out == (f"x mean={s['mean']:.4f} std={s['std']:.4f} min={s['min']:.4f} "
                                       f"max={s['max']:.4f}\n")
    grads = {"a": torch.zeros(3), "b": torch.tensor([0.0, 1e-30]), "c": torch.ones(2)}
    assert port_debug.check_grads_exist(grads) == ["a"]
    assert jax_debug.check_grads_exist({k: jnp.asarray(v.numpy()) for k, v in grads.items()}) == ["a"]
