"""The rest of the optimiser menu and moments stored in bf16, against
``ctgan_tpu`` on the CPU.

* Every rule (Adam, RMSProp, Nadam, Adamax, momentum, SGD) for 10 steps on
  the quadratic of ``tests/test_trainer_modes.py``'s
  ``test_with_state_dtype_rule_equivalence``, with fp32 and with bf16
  moments (``with_state_dtype``): params within 1e-6 relative of JAX's; a
  bf16 moment within one bf16 ulp of JAX's (its bits within 1; expected
  equal).
* The flagship trainer (dim 16) and the 64 px trainer with
  ``opt_state_dtype="bfloat16"``, 2 iterations on the JAX side's draws: the
  fp32 runs' tolerances (``tests/test_torch_train.py``,
  ``tests/test_torch_gan_trainer.py``), which are wider than a bf16 ulp of
  a moment; the moments stay bf16 and ``t`` a float.
* Checkpoints with bf16 moments, both ways, at equal bits (``|V2`` in the
  file, as the JAX package writes it), and a resumed port run equal to one
  run straight through (max diff 0).
* The flagship app from the command line with ``--REMAT 1
  --OPT_STATE_DTYPE bfloat16``, resumed from its own checkpoint (dim 16,
  the small synthetic set).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ctgan_tpu.models import resnet_cifar as jax_resnet
from ctgan_tpu.train import AcganConfig as JaxAcganConfig
from ctgan_tpu.train import make_acgan_trainer
from ctgan_tpu.train import optim as jax_optim
from ctgan_tpu.utils import checkpoint as jax_ckpt

from ctgan_tpu_torch.bridge import state_from_jax, state_to_jax
from ctgan_tpu_torch.core import Randomness
from ctgan_tpu_torch.models import resnet_cifar as port_resnet
from ctgan_tpu_torch.train import AcganConfig, AcganTrainer
from ctgan_tpu_torch.train import optim as port_optim
from ctgan_tpu_torch.utils import checkpoint as port_ckpt

from test_torch_cross_resume import SMALL, small_data  # noqa: F401  (small_data: a fixture)
from test_torch_gan_trainer import check_iterations
from test_torch_train import _port_state, assert_params_close
from torch_parity import JaxDraws, dequant_draws, jax_init_params, jax_model_cfg, port_model_cfg

RULES = {
    "adam": (jax_optim.adam, lambda: port_optim.Adam(1e-4)),
    "rmsprop": (jax_optim.rmsprop, port_optim.RMSProp),
    "nadam": (jax_optim.nadam, port_optim.Nadam),
    "adamax": (jax_optim.adamax, port_optim.Adamax),
    "momentum": (jax_optim.momentum, port_optim.Momentum),
    "sgd": (jax_optim.sgd, port_optim.Sgd),
}


def _bits(a) -> np.ndarray:
    """A bf16 array's (ml_dtypes or ``|V2``) or tensor's bit patterns as int16."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.int16)


def _f64(a) -> np.ndarray:
    t = a if isinstance(a, torch.Tensor) else port_ckpt.as_tensor(np.asarray(a))
    return t.double().numpy()


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rule", list(RULES))
def test_rule_matches_jax(rule, bf16):
    """10 steps on ``grad = w - sin(i)`` from ``linspace(-1, 1, 32)``."""
    jax_mk, port_mk = RULES[rule]
    j_opt, p_opt = jax_mk(), port_mk()
    if bf16:
        j_opt, p_opt = jax_optim.with_state_dtype(j_opt, jnp.bfloat16), port_optim.with_state_dtype(p_opt, "bfloat16")
    w0 = np.linspace(-1.0, 1.0, 32, dtype=np.float32)
    target = np.sin(np.arange(32, dtype=np.float32))
    j_params, p_params = {"w": jnp.asarray(w0)}, {"w": torch.from_numpy(w0.copy())}
    j_state, p_state = j_opt.init(j_params), p_opt.init(p_params)
    for step in range(10):
        j_params, j_state = j_opt.update({"w": j_params["w"] - target}, j_state, j_params,
                                         jnp.asarray(step, jnp.float32))
        p_opt.update({"w": p_params["w"] - torch.from_numpy(target)}, p_state, p_params, step)
        np.testing.assert_allclose(p_params["w"].numpy(), np.asarray(j_params["w"]), rtol=1e-6, atol=1e-7,
                                   err_msg=f"{rule} step {step}")
    assert set(p_state) == set(j_state)
    for key, tree in j_state.items():
        if not isinstance(tree, dict):
            assert p_state[key] == float(tree) and isinstance(p_state[key], float), key
            continue
        got, want = p_state[key]["w"], tree["w"]
        if bf16:
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, key
            assert np.abs(_bits(got).astype(np.int32) - _bits(want).astype(np.int32)).max() <= 1, key
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9, err_msg=key)


def test_with_state_dtype_rounds_once_and_keeps_fp32_params():
    """The moments written back are the round-to-nearest-even bf16 of the
    unrounded fp32 update, and the params are computed from the unrounded
    moments: equal to an fp32 Adam step from the upcast moments."""
    rng = np.random.default_rng(3)
    w, g = rng.normal(size=(5, 7)).astype(np.float32), rng.normal(size=(5, 7)).astype(np.float32)
    opt = port_optim.with_state_dtype(port_optim.Adam(1e-3, 0.5, 0.9), torch.bfloat16)
    assert port_optim.with_state_dtype(opt.opt, "float32") is opt.opt
    params = {"w": torch.from_numpy(w.copy())}
    state = opt.init(params)
    state["m"]["w"].copy_(torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32)))
    state["v"]["w"].copy_(torch.from_numpy(rng.uniform(size=(5, 7)).astype(np.float32)))
    ref_state = {"m": {"w": state["m"]["w"].float()}, "v": {"w": state["v"]["w"].float()}, "t": 0.0}
    ref_params = {"w": torch.from_numpy(w.copy())}
    opt.update({"w": torch.from_numpy(g)}, state, params, 0)
    port_optim.Adam(1e-3, 0.5, 0.9).update({"w": torch.from_numpy(g)}, ref_state, ref_params, 0)
    assert torch.equal(params["w"], ref_params["w"]) and params["w"].dtype == torch.float32
    for k in ("m", "v"):
        assert state[k]["w"].dtype == torch.bfloat16
        assert torch.equal(state[k]["w"], ref_state[k]["w"].to(torch.bfloat16)), k
    assert state["t"] == 1.0
    with pytest.raises(ValueError, match="floating dtype"):
        port_optim.with_state_dtype(port_optim.Sgd(), "int8")


@pytest.mark.parametrize("rule", ["adam", "nadam", "adamax", "rmsprop", "momentum"])
def test_narrow_moments_update_in_groups_as_in_one(rule, monkeypatch):
    """With bf16 moments the parameters go through in groups of at most
    ``GROUP_ELEMENTS`` elements (bounding the fp32 working copies); the
    result does not depend on the grouping, bit for bit.  fp32 moments are
    one group, updated in place."""
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 5), "b": (40,), "c": (2, 2, 3), "d": (7,)}
    grads = [{k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
             for _ in range(3)]
    w0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    runs = []
    for limit in (1 << 22, 20):
        monkeypatch.setattr(port_optim, "GROUP_ELEMENTS", limit)
        opt = port_optim.with_state_dtype(RULES[rule][1](), "bfloat16")
        params = {k: torch.from_numpy(v.copy()) for k, v in w0.items()}
        state = opt.init(params)
        assert len(port_optim._groups(params, state)) == (1 if limit > 100 else 3)
        for step, g in enumerate(grads):
            opt.update(g, state, params, step)
        runs.append((params, state))
    (p1, s1), (p2, s2) = runs
    assert all(torch.equal(p1[k], p2[k]) for k in shapes)
    assert all(torch.equal(s1[key][k], s2[key][k]) for key in s1 if isinstance(s1[key], dict) for k in shapes)
    fp32 = RULES[rule][1]()
    params = {k: torch.from_numpy(v.copy()) for k, v in w0.items()}
    assert port_optim._groups(params, fp32.init(params)) == [list(shapes)]


# --------------------------------------------------------------- the trainers

DIM, BATCH, N_CRITIC, ITERS, LR = 16, 4, 2, 4, 2e-4


def _flagship_trainers(**extra):
    jcfg, pcfg = jax_model_cfg(DIM), port_model_cfg(DIM)
    jax_trainer = make_acgan_trainer(
        lambda n, labels, noise=None: jax_resnet.generator(n, labels, noise=noise, cfg=jcfg),
        lambda x, labels, k1, k2, k3: jax_resnet.discriminator(x, labels, k1, k2, k3, jcfg),
        JaxAcganConfig(batch_size=BATCH, critic_iters=N_CRITIC, iters=ITERS, lr=LR, **extra),
    )
    port_trainer = AcganTrainer(
        lambda p, n, labels, rand, noise=None: port_resnet.generator(p, n, labels, pcfg, rand, noise=noise),
        lambda p, x, labels, kps, rand: port_resnet.discriminator(p, x, labels, kps, pcfg, rand),
        AcganConfig(batch_size=BATCH, critic_iters=N_CRITIC, iters=ITERS, lr=LR, **extra),
    )
    return jax_trainer, port_trainer


def _assert_bf16_moments(opt: dict) -> None:
    for key in ("m", "v"):
        assert all(t.dtype == torch.bfloat16 for t in opt[key].values()), key
    assert isinstance(opt["t"], float)


def test_flagship_trainer_with_bf16_moments_matches_jax(monkeypatch):
    """``tests/test_torch_train.py``'s two iterations with
    ``opt_state_dtype="bfloat16"`` on both sides, the port started from
    JAX's state at each step: metrics to rtol 1e-4, params within
    ``adam_mismatches``; the moments bf16, within the fp32 gradients'
    tolerance of JAX's (each tensor's largest, 1e-2; a bf16 ulp is 2**-8 of
    a value)."""
    gen, disc = jax_init_params(DIM, seed=5)
    draws = JaxDraws(monkeypatch)
    (init_state, step_fn, *_), port_trainer = _flagship_trainers(opt_state_dtype="bfloat16")
    rng = np.random.default_rng(7)
    real = rng.integers(0, 256, size=(N_CRITIC, BATCH, 3072)).astype(np.int32)
    labels = rng.integers(0, 10, size=(N_CRITIC, BATCH)).astype(np.int32)
    base_key = jax.random.PRNGKey(123)
    jstep = jax.jit(step_fn)
    states, metrics = [init_state(gen, disc)], []
    for _ in range(2):
        s, m = jstep(states[-1], real, labels, base_key)
        states.append(s)
        metrics.append(m)
    zero_grad = port_resnet.zero_grad_params(port_model_cfg(DIM))
    for step in (0, 1):
        state = _port_state(states[step])
        _assert_bf16_moments(state.disc_opt)
        rand = draws.injected(dequant_draws(base_key, step, N_CRITIC, (BATCH, 3072)))
        got = port_trainer.step(state, torch.from_numpy(real.astype(np.uint8)), torch.from_numpy(labels).long(),
                                rand)
        assert rand.exhausted() and state.step == step + 1
        want = states[step + 1]
        for k, v in metrics[step].items():
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
        assert_params_close(state.disc_params, want.disc_params, zero_grad, n_updates=N_CRITIC)
        assert_params_close(state.gen_params, want.gen_params, zero_grad, n_updates=step)
        blob = state_to_jax(state)  # the JAX layout
        for field in ("gen_opt", "disc_opt"):
            ours, theirs = getattr(state, field), getattr(want, field)
            _assert_bf16_moments(ours)
            assert ours["t"] == float(theirs["t"]) and theirs["t"].dtype == jnp.float32
            scale = max(float(np.abs(_f64(v)).max()) for v in theirs["m"].values())
            for k, v in theirs["m"].items():
                dev = float(np.abs(_f64(blob[field]["m"][k]) - _f64(v)).max())
                assert dev <= 1e-2 * scale, (field, k, dev / scale)


def test_good64_trainer_with_bf16_moments_matches_jax(monkeypatch):
    """``tests/test_torch_gan_trainer.py``'s ``check_iterations`` (wgan-ct,
    dim 8) with ``opt_state_dtype="bfloat16"`` on both sides; the moments
    stay bf16 (checked there)."""
    check_iterations("wgan-ct", dict(opt_state_dtype="bfloat16"), monkeypatch)


# --------------------------------------------------------------- checkpoints


def _trained_port(opt_state_dtype: str = "bfloat16", steps: int = 2):
    trainer = _flagship_trainers(opt_state_dtype=opt_state_dtype)[1]
    gen, disc = jax_init_params(DIM, seed=3)
    from torch_parity import to_port

    state = trainer.init_state(to_port(gen), to_port(disc))
    return trainer, state


def _batch(step: int):
    rng = np.random.default_rng(step)
    return (torch.from_numpy(rng.integers(0, 256, (N_CRITIC, BATCH, 3072), dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 10, (N_CRITIC, BATCH))))


def _port_steps(trainer, state, steps) -> None:
    for step in steps:
        trainer.step(state, *_batch(step), Randomness(0, "cpu").for_step(step))


def test_jax_bf16_checkpoint_loads_into_the_port_and_resumes(tmp_path):
    """A JAX state with bf16 moments (``init_state`` of the JAX trainer with
    ``opt_state_dtype="bfloat16"``, its moments set to seeded normals, its
    step to 1), saved by the JAX package as its loop saves one: the port
    reads each moment with the same bits, bf16, and trains on from it
    (moments bf16, finite).  (The JAX app cannot resume from such a file
    itself: its loop hands the ``|V2`` arrays to ``jit``; ROADMAP, Queue 3.)"""
    gen, disc = jax_init_params(DIM, seed=6)
    (init_state, *_), port_trainer = _flagship_trainers(opt_state_dtype="bfloat16")
    jstate = init_state(gen, disc)
    rng = np.random.default_rng(2)
    def moments(tree, sign=lambda a: a):  # v: |normal|
        return {k: jnp.asarray(sign(rng.normal(scale=1e-3, size=v.shape)), jnp.bfloat16) for k, v in tree.items()}

    jstate = jstate._replace(step=jnp.asarray(1, jstate.step.dtype), **{
        f: dict(getattr(jstate, f), m=moments(getattr(jstate, f)["m"]), v=moments(getattr(jstate, f)["v"], np.abs),
                t=jnp.asarray(1.0, jnp.float32)) for f in ("gen_opt", "disc_opt")})
    assert getattr(jstate.disc_opt["m"][next(iter(jstate.disc_opt["m"]))], "dtype") == jnp.bfloat16
    path = jax_ckpt.save_checkpoint(str(tmp_path / "ckpt_1.npz"), {"state": jstate._asdict(),
                                                                    "loop": {"iteration": 1}})
    blob = port_ckpt.load_checkpoint(path)
    assert blob["state"]["disc_opt"]["m"][next(iter(jstate.disc_opt["m"]))].dtype == np.dtype("V2")
    state = state_from_jax(blob["state"], "cpu")
    ours = state_to_jax(state)
    for field in ("gen_opt", "disc_opt"):
        for key in ("m", "v"):
            for k, v in getattr(jstate, field)[key].items():
                np.testing.assert_array_equal(_bits(ours[field][key][k]), _bits(v), err_msg=(field, key, k))
        _assert_bf16_moments(getattr(state, field))
    assert state.step == 1
    _port_steps(port_trainer, state, [1])
    assert state.step == 2
    _assert_bf16_moments(state.disc_opt)
    assert all(bool(torch.isfinite(t.float()).all()) for t in state.disc_opt["m"].values())


def test_port_bf16_checkpoint_loads_in_jax_as_its_bits(tmp_path):
    """The port's file holds each bf16 moment as ``|V2``, the form the JAX
    package writes and reads (``np.savez`` of its bf16 arrays); JAX's
    ``load_checkpoint`` gives the same bits."""
    trainer, state = _trained_port()
    _port_steps(trainer, state, [0, 1])
    ours = state_to_jax(state)
    path = port_ckpt.save_checkpoint(str(tmp_path / "ckpt_2.npz"), {"state": ours})
    blob = jax_ckpt.load_checkpoint(path)
    for field in ("gen_opt", "disc_opt"):
        for key in ("m", "v"):
            for k, t in getattr(state, field)[key].items():
                leaf = blob["state"][field][key][k]
                assert leaf.dtype == np.dtype("V2"), (field, key, k)
                np.testing.assert_array_equal(_bits(leaf), _bits(ours[field][key][k]), err_msg=(field, key, k))
                # the same values as the port's bf16 tensor, in the JAX layout
                np.testing.assert_array_equal(np.asarray(jnp.asarray(leaf.view(jnp.bfloat16)), np.float32),
                                              _f64(ours[field][key][k]).astype(np.float32))
        assert float(blob["state"][field]["t"]) == getattr(state, field)["t"]


def test_port_resumed_from_its_bf16_checkpoint_equals_a_straight_run(tmp_path):
    """Two iterations + checkpoint + a fresh trainer and state + two,
    against four straight: every array of the state equal (max diff 0)."""
    trainer, straight = _trained_port()
    _port_steps(trainer, straight, range(4))
    trainer, first = _trained_port()
    _port_steps(trainer, first, range(2))
    path = port_ckpt.save_checkpoint(str(tmp_path / "ckpt_2.npz"), {"state": state_to_jax(first)})
    trainer, _ = _trained_port()
    resumed = state_from_jax(port_ckpt.load_checkpoint(path)["state"], "cpu")
    _port_steps(trainer, resumed, range(2, 4))
    want, got = state_to_jax(straight), state_to_jax(resumed)
    for field in want:
        if field == "step":
            assert int(got[field]) == int(want[field]) == 4
            continue
        for k, v in want[field].items():
            if isinstance(v, dict):
                for n, a in v.items():
                    np.testing.assert_array_equal(got[field][k][n].view(np.uint8), a.view(np.uint8),
                                                  err_msg=(field, k, n))
            else:
                np.testing.assert_array_equal(got[field][k], v, err_msg=(field, k))
    _assert_bf16_moments(resumed.disc_opt)


# --------------------------------------------------------------- the flagship app

def test_flagship_cli_trains_and_resumes_with_remat_and_bf16_moments(tmp_path, small_data, capsys):
    """``python -m ctgan_tpu_torch --platform cpu flagship --REMAT 1
    --OPT_STATE_DTYPE bfloat16 ...`` for 2 iterations, then again to 3: it
    resumes from its own checkpoint, and the moments stay bf16."""
    from ctgan_tpu_torch.__main__ import main as cli

    argv = ["--platform", "cpu", "flagship", "--REMAT", "1", "--OPT_STATE_DTYPE", "bfloat16",
            "--out_dir", str(tmp_path)] + [a for k, v in SMALL.items() for a in (f"--{k}", str(v))]
    assert cli(argv + ["--ITERS", "2"]) == 0
    assert cli(argv + ["--ITERS", "3"]) == 0
    assert f"resumed from {tmp_path / 'ckpt' / 'ckpt_2.npz'} at iteration 2" in capsys.readouterr().out
    blob = port_ckpt.load_checkpoint(str(tmp_path / "ckpt" / "ckpt_2.npz"))
    assert {a.dtype for a in blob["state"]["disc_opt"]["m"].values()} == {np.dtype("V2")}
