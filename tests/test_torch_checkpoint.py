"""Checkpoints between ``ctgan_tpu_torch`` and ``ctgan_tpu`` on the CPU: each
package reads what the other writes, a trainer state crosses the layout
bridge exactly, and the JAX run's dim-128 checkpoint
``runs/flagship_fused_r4/ckpt/ckpt_25000.npz`` loads into the port."""

from __future__ import annotations

import json
import os
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ctgan_tpu.train import AcganConfig as JaxAcganConfig
from ctgan_tpu.train import make_acgan_trainer
from ctgan_tpu.models import resnet_cifar as jax_resnet
from ctgan_tpu.utils import checkpoint as jax_ckpt

from ctgan_tpu_torch.bridge import state_from_jax, state_to_jax
from ctgan_tpu_torch.train import AcganConfig, AcganTrainer
from ctgan_tpu_torch.train.loop import _prune_checkpoints
from ctgan_tpu_torch.utils import checkpoint as port_ckpt

from torch_parity import jax_init_params, jax_model_cfg, to_port

ROOT = Path(__file__).resolve().parents[1]
JAX_CKPT = ROOT / "runs" / "flagship_fused_r4" / "ckpt" / "ckpt_25000.npz"
Pair = namedtuple("Pair", ["first", "second"])


def _tree(rng):
    return {
        "a": rng.normal(size=(3, 4)).astype(np.float32),
        "b": (rng.integers(0, 9, size=(5,)).astype(np.int32), None, 3, "text", True, 2.5),
        "c": [np.float32(1.5), {"d": np.arange(6, dtype=np.int64).reshape(2, 3)}],
        "e": np.array(7, np.int32),
    }


def _assert_tree_equal(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}[{i}]")
    elif want is None or isinstance(want, (str, bool, int, float)) and not isinstance(want, np.generic):
        assert got == want and type(got) is type(want), path
    else:
        got = np.asarray(got)
        assert got.dtype == np.asarray(want).dtype, path
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=path)


def test_port_writes_and_jax_reads(tmp_path):
    """Nested dict/tuple/list/None/scalar trees, with a tensor leaf and a
    namedtuple: JAX's loader gives equal arrays and the same structure
    (a namedtuple comes back as a dict in both packages)."""
    tree = _tree(np.random.default_rng(0))
    tree["t"] = torch.arange(4, dtype=torch.float32)
    tree["nt"] = Pair(np.ones(2, np.float32), [None])
    path = port_ckpt.save_checkpoint(str(tmp_path / "sub" / "port.npz"), tree)
    assert sorted(os.listdir(tmp_path / "sub")) == ["port.npz"]  # no temporary file left
    got = jax_ckpt.load_checkpoint(path)
    want = dict(tree, t=np.arange(4, dtype=np.float32), nt={"first": np.ones(2, np.float32), "second": [None]})
    _assert_tree_equal(got, want)
    _assert_tree_equal(port_ckpt.load_checkpoint(path), want)


def test_jax_writes_and_port_reads(tmp_path):
    tree = _tree(np.random.default_rng(1))
    tree["j"] = jnp.linspace(0.0, 1.0, 5)
    path = jax_ckpt.save_checkpoint(str(tmp_path / "jax.npz"), tree)
    got = port_ckpt.load_checkpoint(path)
    _assert_tree_equal(got, dict(tree, j=np.asarray(tree["j"])))


def test_same_structure_json_as_jax(tmp_path):
    tree = _tree(np.random.default_rng(2))
    with np.load(port_ckpt.save_checkpoint(str(tmp_path / "p.npz"), tree)) as p, \
            np.load(jax_ckpt.save_checkpoint(str(tmp_path / "j.npz"), tree)) as j:
        assert sorted(p.files) == sorted(j.files)
        assert bytes(p["__structure_json__"]) == bytes(j["__structure_json__"])


def test_sidecar_structure_is_still_read(tmp_path):
    """First-round JAX checkpoints kept the structure in ``<path>.json``."""
    arrays, struct = port_ckpt._flatten({"w": np.arange(3.0), "n": 4})
    path = str(tmp_path / "old.npz")
    np.savez(path, **arrays)
    (tmp_path / "old.npz.json").write_text(json.dumps(struct))
    got = port_ckpt.load_checkpoint(path)
    assert got["n"] == 4
    np.testing.assert_array_equal(got["w"], np.arange(3.0))


def test_device_get_copies_in_one_batch_per_dtype():
    tensors = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(2, 2).t(), torch.tensor(3)],
               "c": "kept", "d": np.zeros(1)}
    host = port_ckpt.device_get(tensors)
    np.testing.assert_array_equal(host["a"], np.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(host["b"][0], np.ones((2, 2)))
    assert host["b"][1] == 3 and host["b"][1].dtype == np.int64
    assert host["c"] == "kept" and host["d"] is tensors["d"]
    host["a"][0, 0] = 99.0  # owns its memory
    assert float(tensors["a"][0, 0]) == 0.0


def _port_trainer(dim=8):
    from ctgan_tpu_torch.models import resnet_cifar as port_resnet

    mcfg = port_resnet.ResnetCifarConfig(dim_g=dim, dim_d=dim)
    return AcganTrainer(
        lambda p, n, labels, rand, noise=None: port_resnet.generator(p, n, labels, mcfg, rand, noise=noise),
        lambda p, x, labels, kps, rand: port_resnet.discriminator(p, x, labels, kps, mcfg, rand),
        AcganConfig(batch_size=2, critic_iters=1, iters=10),
    )


def test_state_round_trip_is_exact():
    """A trained state (non-zero Adam moments) through ``state_to_jax`` and
    ``state_from_jax``: every tensor bit-equal, ``t`` and ``step`` equal;
    the blob holds exactly the JAX ``AcganState`` fields, ``t`` a 0-d
    float32 and ``step`` a 0-d int32, as in ``ckpt_25000.npz``."""
    from ctgan_tpu_torch.core import Randomness

    trainer = _port_trainer()
    gen, disc = jax_init_params(8, seed=3)
    state = trainer.init_state(to_port(gen), to_port(disc))
    rng = np.random.default_rng(0)
    real = torch.from_numpy(rng.integers(0, 256, (1, 2, 3072), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 10, (1, 2)))
    for step in range(2):
        trainer.step(state, real, labels, Randomness(0, "cpu").for_step(step))
    blob = state_to_jax(state)
    assert list(blob) == ["gen_params", "disc_params", "gen_opt", "disc_opt", "step"]
    assert set(blob) == set(jax_resnet_state_fields())
    assert blob["step"].dtype == np.int32 and blob["step"].shape == () and int(blob["step"]) == 2
    assert blob["gen_opt"]["t"].dtype == np.float32 and float(blob["gen_opt"]["t"]) == 1.0
    assert float(blob["disc_opt"]["t"]) == 2.0
    back = state_from_jax(blob, "cpu")
    assert back.step == state.step and back.gen_opt["t"] == state.gen_opt["t"]
    for field in ("gen_params", "disc_params"):
        for k, v in getattr(state, field).items():
            assert torch.equal(getattr(back, field)[k], v.detach()), k
            assert getattr(back, field)[k].requires_grad
    for field in ("gen_opt", "disc_opt"):
        for moment in ("m", "v"):
            for k, v in getattr(state, field)[moment].items():
                assert torch.equal(getattr(back, field)[moment][k], v), (field, moment, k)
    again = state_to_jax(back)
    for path, a in _leaves(blob):
        np.testing.assert_array_equal(_get(again, path), a, err_msg=str(path))


def jax_resnet_state_fields():
    from ctgan_tpu.train.trainer_acgan import AcganState as JaxAcganState

    return JaxAcganState._fields


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_jax_loop_restores_a_port_state(tmp_path):
    """What the JAX loop does with a checkpoint (``AcganState(**blob["state"])``,
    ``ctgan_tpu/train/loop.py:127``) works on the port's, and the restored
    state steps under the jitted JAX step."""
    from ctgan_tpu.train.trainer_acgan import AcganState as JaxAcganState

    trainer = _port_trainer()
    gen, disc = jax_init_params(8, seed=4)
    state = trainer.init_state(to_port(gen), to_port(disc))
    path = port_ckpt.save_checkpoint(str(tmp_path / "ckpt_1.npz"), {
        "state": state_to_jax(state), "loop": {"iteration": 1}, "data_state": {"i": 1}})
    blob = jax_ckpt.load_checkpoint(path)
    restored = JaxAcganState(**blob["state"])
    assert int(restored.step) == 0 and blob["loop"]["iteration"] == 1 and blob["data_state"]["i"] == 1
    jcfg = jax_model_cfg(8)
    init_state, step_fn, *_ = make_acgan_trainer(
        lambda n, labels, noise=None: jax_resnet.generator(n, labels, noise=noise, cfg=jcfg),
        lambda x, labels, k1, k2, k3: jax_resnet.discriminator(x, labels, k1, k2, k3, jcfg),
        JaxAcganConfig(batch_size=2, critic_iters=1, iters=10),
    )
    fresh = init_state(gen, disc)
    assert jax.tree_util.tree_structure(jax.tree.map(jnp.asarray, restored)) == \
        jax.tree_util.tree_structure(fresh)
    real = np.zeros((1, 2, 3072), np.int32)
    new, metrics = jax.jit(step_fn)(jax.tree.map(jnp.asarray, restored), real,
                                    np.zeros((1, 2), np.int32), jax.random.PRNGKey(0))
    assert int(new.step) == 1 and np.isfinite(float(metrics["disc_cost"]))


def test_jax_dim128_checkpoint_loads_into_the_port():
    """``ckpt_25000.npz`` (written by the JAX loop on a TPU) becomes a port
    ``AcganState`` whose names and shapes are those of JAX's ``init_state``
    at dim 128 after the layout conversion; back through ``state_to_jax``
    it equals the file exactly."""
    blob = port_ckpt.load_checkpoint(str(JAX_CKPT))
    assert blob["loop"] == {"iteration": 25000} and blob["data_state"] == {"i": 25000}
    state = state_from_jax(blob["state"], "cpu")
    assert state.step == 25000 and state.gen_opt["t"] == 24999.0 and state.disc_opt["t"] == 125000.0
    jcfg = jax_model_cfg(128)
    init_state, *_ = make_acgan_trainer(
        lambda n, labels, noise=None: jax_resnet.generator(n, labels, noise=noise, cfg=jcfg),
        lambda x, labels, k1, k2, k3: jax_resnet.discriminator(x, labels, k1, k2, k3, jcfg),
        JaxAcganConfig(),
    )
    want = init_state(*jax_init_params(128, seed=0))
    for field in ("gen_params", "disc_params"):
        expected = {k: tuple(v.shape) for k, v in to_port(getattr(want, field), False).items()}
        assert {k: tuple(v.shape) for k, v in getattr(state, field).items()} == expected, field
        for moment in ("m", "v"):
            got = {k: tuple(v.shape) for k, v in getattr(state, field.replace("params", "opt"))[moment].items()}
            assert got == expected, (field, moment)
    again = state_to_jax(state)
    for path, a in _leaves(blob["state"]):
        b = _get(again, path)
        assert b.dtype == a.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=str(path))


def test_latest_checkpoint_picks_the_highest_step(tmp_path):
    assert port_ckpt.latest_checkpoint(str(tmp_path / "absent")) is None
    assert port_ckpt.latest_checkpoint(str(tmp_path)) is None
    for name in ("ckpt_9.npz", "ckpt_10.npz", "ckpt_best.npz", "other_99.npz", "ckpt_11.npz.tmp"):
        (tmp_path / name).write_bytes(b"")
    assert port_ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_10.npz")
    assert port_ckpt.latest_checkpoint(str(tmp_path)) == jax_ckpt.latest_checkpoint(str(tmp_path))


def test_prune_checkpoints_skips_unparseable_and_sidecars(tmp_path):
    """As ``tests/test_loop_extra.py``: a kept ``ckpt_best.npz`` survives
    pruning, a pruned checkpoint's legacy ``.json`` sidecar goes with it."""
    d = str(tmp_path)
    for step in (100, 200, 300, 400):
        open(os.path.join(d, f"ckpt_{step}.npz"), "w").close()
    open(os.path.join(d, "ckpt_100.npz.json"), "w").close()
    open(os.path.join(d, "ckpt_best.npz"), "w").close()
    _prune_checkpoints(d, keep=2)
    assert sorted(os.listdir(d)) == ["ckpt_300.npz", "ckpt_400.npz", "ckpt_best.npz"]


def test_save_checkpoint_refuses_the_reserved_key(tmp_path):
    with pytest.raises(ValueError, match="reserved"):
        port_ckpt.save_checkpoint(str(tmp_path / "x.npz"), {"__structure_json__": np.zeros(1)})
    assert os.listdir(tmp_path) == []
