"""Ahead-of-time serving (``ctgan_tpu_torch/utils/aot.py`` and
``apps/generate.py``'s ``--aot_save``/``--aot``) on the CPU, at small
widths: the loaded program gives the eager sampler's samples bit for bit
(the same aten ops in the same order on the same draws), the record refuses
what it should, and one artifact serves every checkpoint of its model."""

from __future__ import annotations

import json
import zipfile

import numpy as np
import pytest
import torch

from ctgan_tpu_torch.apps import generate
from ctgan_tpu_torch.bridge import to_jax_params
from ctgan_tpu_torch.utils import save_checkpoint
from ctgan_tpu_torch.utils import aot

import torch_parity  # noqa: F401  (one intra-op thread per test worker)

SMALL = {"cifar_resnet": 16, "good64": 8, "mnist": 8, "cifar": 8}
CPU = torch.device("cpu")


def _cfg(model="cifar_resnet", **kw) -> generate.Config:
    return generate.Config(**({"model": model, "dim": SMALL[model], "batch": 4} | kw))


def _ckpt(path, cfg: generate.Config, seed: int) -> str:
    """A checkpoint of fresh G weights drawn from ``seed``."""
    params = generate._gen_params(generate.Config(**(cfg.__dict__ | {"seed": seed, "ckpt": ""})), CPU)
    return save_checkpoint(str(path), {"gen_params": to_jax_params(params)})


def _export(path, cfg: generate.Config) -> dict:
    return generate.main(cfg=generate.Config(**(cfg.__dict__ | {"aot_save": str(path)})), device="cpu")


def _rewrite_record(src, dst, **env) -> None:
    """Copy the artifact ``src`` to ``dst`` with its record's environment
    changed."""
    record = aot.read_record(str(src))
    record["env"].update(env)
    program = torch.export.load(str(src))
    torch.export.save(program, str(dst), extra_files={aot.RECORD: json.dumps(record)})


@pytest.fixture(scope="module")
def flagship_artifact(tmp_path_factory):
    path = tmp_path_factory.mktemp("aot") / "flagship_b4.pt2"
    _export(path, _cfg())
    return path


@pytest.mark.parametrize("model,bf16", [("cifar_resnet", False), ("cifar_resnet", True), ("good64", False),
                                        ("mnist", False), ("cifar", False)])
def test_round_trip_equals_the_eager_sampler(tmp_path, model, bf16):
    """``--aot_save`` then ``--aot`` in ``main``: the samples of ``n = 2 *
    batch`` equal a plain run's bit for bit; the record holds the model,
    batch, dim and precision."""
    cfg = _cfg(model, bf16=bf16, n=8, ckpt=_ckpt(tmp_path / "g.npz", _cfg(model), 5))
    record = _export(tmp_path / "a.pt2", cfg)
    assert {k: record[k] for k in ("model", "batch", "dim", "bf16", "platform")} == {
        "model": model, "batch": 4, "dim": SMALL[model], "bf16": bf16, "platform": "cpu"}
    assert record["aot_path"] == str(tmp_path / "a.pt2") and record["compile_sec"] >= 0
    eager = generate.main(cfg=generate.Config(**(cfg.__dict__ | {"out_prefix": str(tmp_path / "e")})), device="cpu")
    served = generate.main(cfg=generate.Config(**(cfg.__dict__ | {"aot": str(tmp_path / "a.pt2"),
                                                                  "out_prefix": str(tmp_path / "a")})), device="cpu")
    assert served.shape == eager.shape == (8, int(np.prod(generate._SHAPES[model])))
    np.testing.assert_array_equal(served, eager)


def test_one_artifact_serves_two_checkpoints(tmp_path, flagship_artifact):
    """The program's inputs are G's params: two checkpoints through one
    artifact give each checkpoint's eager samples."""
    outs = []
    for seed in (1, 2):
        cfg = _cfg(n=4, ckpt=_ckpt(tmp_path / f"g{seed}.npz", _cfg(), seed), out_prefix=str(tmp_path / "x"))
        served = generate.main(cfg=generate.Config(**(cfg.__dict__ | {"aot": str(flagship_artifact)})),
                               device="cpu")
        np.testing.assert_array_equal(served, generate.main(cfg=cfg, device="cpu"))
        outs.append(served)
    assert not np.array_equal(*outs)


def test_ragged_tail_is_padded_then_sliced(tmp_path, flagship_artifact):
    """``n = 6`` at batch 4: the second request runs at the full batch and
    keeps its first 2 samples."""
    cfg = _cfg(n=6, ckpt=_ckpt(tmp_path / "g.npz", _cfg(), 3), aot=str(flagship_artifact),
               out_prefix=str(tmp_path / "r"))
    served = generate.main(cfg=cfg, device="cpu")
    call, meta = generate._aot_sampler(cfg, generate._gen_params(cfg, CPU), CPU)
    assert served.shape == (6, 3072) and meta["batch"] == 4
    np.testing.assert_array_equal(served[:4], call(cfg.seed * 1_000_003).float().numpy())
    np.testing.assert_array_equal(served[4:], call(cfg.seed * 1_000_003 + 4)[:2].float().numpy())


def test_strict_and_lenient_environment_mismatch(tmp_path, flagship_artifact, capsys):
    """Another device name, torch version or platform: ``strict`` raises
    with the rebuild advice; ``strict=False`` warns on stderr and loads."""
    for env in ({"device_name": "NVIDIA H200"}, {"torch_version": "0.0.1"}, {"platform": "cuda"}):
        _rewrite_record(flagship_artifact, tmp_path / "other.pt2", **env)
        with pytest.raises(aot.AotMismatch, match=f"{next(iter(env))}=.*Rebuild with --aot_save"):
            aot.load_aot(str(tmp_path / "other.pt2"), device="cpu")
        program, meta = aot.load_aot(str(tmp_path / "other.pt2"), strict=False, device="cpu")
        assert "warning: AOT artifact" in capsys.readouterr().err
        assert callable(program) and meta["env"][next(iter(env))] == env[next(iter(env))]
    cfg = _cfg(n=4, ckpt=_ckpt(tmp_path / "g.npz", _cfg(), 3), aot=str(tmp_path / "other.pt2"), aot_strict=False,
               out_prefix=str(tmp_path / "l"))
    np.testing.assert_array_equal(generate.main(cfg=cfg, device="cpu"),
                                  generate.main(cfg=generate.Config(**(cfg.__dict__ | {"aot": ""})), device="cpu"))
    with pytest.raises(aot.AotMismatch):
        generate.main(cfg=generate.Config(**(cfg.__dict__ | {"aot_strict": True})), device="cpu")


def test_a_file_that_is_not_an_artifact_is_refused(tmp_path, flagship_artifact):
    junk = tmp_path / "junk.pt2"
    junk.write_bytes(b"not a zip")
    with zipfile.ZipFile(tmp_path / "plain.zip", "w") as zf:
        zf.writestr("archive/extra/ctgan_aot.json", json.dumps({"magic": "something else"}))
    for path in (junk, tmp_path / "plain.zip", tmp_path / "missing.pt2"):
        with pytest.raises(aot.AotMismatch, match="is not a ctgan-tpu-torch-aot-v1 artifact"):
            aot.load_aot(str(path), device="cpu")
    program, meta = aot.load_aot(str(flagship_artifact), device="cpu")
    assert meta["load_sec"] >= 0 and meta["env"] == aot.env_meta("cpu")


@pytest.mark.parametrize("kw,what", [(dict(bf16=True), "bf16"), (dict(model="cifar", dim=16), "model"),
                                     (dict(dim=8), "dim"), (dict(batch=8), "batch")])
def test_another_configuration_is_refused(tmp_path, flagship_artifact, kw, what):
    """A ``--bf16``, ``--model``, ``--dim`` or ``--batch`` other than the
    artifact's is refused, naming what differs."""
    cfg = _cfg(n=4, ckpt=_ckpt(tmp_path / "g.npz", _cfg(), 3), aot=str(flagship_artifact))
    with pytest.raises(SystemExit, match=f"{what} .*asked for"):
        generate.main(cfg=generate.Config(**(cfg.__dict__ | kw)), device="cpu")


def test_save_writes_through_a_tmp_file(tmp_path, flagship_artifact):
    """The artifact is replaced atomically: no ``.tmp`` is left behind, and
    ``serve_iters`` still needs the card."""
    assert not list(flagship_artifact.parent.glob("*.tmp"))
    with pytest.raises(RuntimeError, match="CUDA"):
        generate.main(cfg=_cfg(aot=str(flagship_artifact), serve_iters=2), device="cpu")
