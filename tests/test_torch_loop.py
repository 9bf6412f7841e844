"""The port's training loop, logger and resume safety on the CPU, mirroring
``tests/test_loop_extra.py`` and ``tests/test_resume.py``, plus the flagship
app's resume: a resumed run equals an uninterrupted one.  Resuming across
the two packages is in ``tests/test_torch_cross_resume.py``."""

from __future__ import annotations

import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from ctgan_tpu.utils import MetricLogger as JaxMetricLogger
from ctgan_tpu.utils.resume import logged_progress as jax_logged_progress

from ctgan_tpu_torch.apps import ct_gan_cifar_resnet as app
from ctgan_tpu_torch.bridge import state_to_jax
from ctgan_tpu_torch.train.loop import LoopConfig, train_loop
from ctgan_tpu_torch.utils import MetricLogger
from ctgan_tpu_torch.utils.resume import guard_fresh_start, logged_progress, reap_stale_tmps

import torch_parity  # noqa: F401  (one intra-op thread per test worker)


def _toy_state():
    return {"x": torch.zeros(()), "step": 0}


def _toy_step(state, batch, rand):
    new_x = state["x"] + batch.mean()
    return {"x": new_x, "step": state["step"] + 1}, {"cost": new_x}


def _nan_step(state, batch, rand):
    bad = torch.tensor(float("nan") if state["step"] >= 2 else 1.0)
    return {"x": state["x"], "step": state["step"] + 1}, {"cost": bad}


def _batches():
    return (torch.ones(4, 2),)


def _from_blob(blob):
    return {"x": torch.as_tensor(blob["x"]), "step": int(blob["step"])}


def test_nan_tripwire_halts():
    cfg = LoopConfig(iters=10, print_every=100, nan_check_every=1)
    with pytest.raises(FloatingPointError, match="cost"):
        train_loop(_toy_state(), _nan_step, _batches, None, cfg)


def test_loop_runs_and_checkpoints(tmp_path):
    cfg = LoopConfig(iters=6, print_every=3, save_every=2, ckpt_dir=str(tmp_path))
    out = train_loop(_toy_state(), _toy_step, _batches, None, cfg, logger=MetricLogger(),
                     from_blob=_from_blob)
    assert out["step"] == 6
    assert sorted(os.listdir(tmp_path)) == ["ckpt_2.npz", "ckpt_4.npz", "ckpt_6.npz"]
    # resume from the checkpoint continues at the right iteration
    cfg2 = LoopConfig(iters=8, print_every=3, save_every=100, ckpt_dir=str(tmp_path))
    out2 = train_loop(_toy_state(), _toy_step, _batches, None, cfg2, from_blob=_from_blob)
    assert out2["step"] == 8 and float(out2["x"]) == 8.0


def test_keep_checkpoints_prunes(tmp_path):
    cfg = LoopConfig(iters=10, print_every=100, save_every=2, ckpt_dir=str(tmp_path),
                     keep_checkpoints=2)
    train_loop(_toy_state(), _toy_step, _batches, None, cfg)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_10.npz", "ckpt_8.npz"]


def test_final_partial_window_is_flushed(tmp_path):
    """Metrics buffered since the last cadence flush are emitted when the
    loop exits, labelled by the last iteration they cover."""
    cfg = LoopConfig(iters=12, print_every=100, print_first=5, nan_check_every=None)
    logger = MetricLogger(out_dir=str(tmp_path))
    train_loop(_toy_state(), _toy_step, _batches, None, cfg, logger=logger)
    rows = [json.loads(line) for line in open(tmp_path / "log.ndjson")]
    assert [r["iteration"] for r in rows] == [0, 1, 2, 3, 4, 11]
    # the tail window's mean covers iterations 5..11: cost = x after each step
    np.testing.assert_allclose(rows[-1]["cost"], np.mean(np.arange(6, 13)))
    assert not logger.pending and all("wall_time" in r and "time" in r for r in rows)
    assert logger.records == rows


def test_time_based_print(capsys):
    cfg = LoopConfig(iters=3, print_every=10**9, print_first=0, print_every_secs=0.0001,
                     nan_check_every=None)
    train_loop(_toy_state(), _toy_step, _batches, None, cfg)
    assert capsys.readouterr().out.count("cost") >= 2


def test_save_every_secs_saves(tmp_path):
    cfg = LoopConfig(iters=3, print_every=100, save_every_secs=0.0001, ckpt_dir=str(tmp_path))
    train_loop(_toy_state(), _toy_step, _batches, None, cfg)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_1.npz", "ckpt_2.npz", "ckpt_3.npz"]


def test_test_fn_and_callback_on_the_test_cadence(tmp_path):
    seen = []
    cfg = LoopConfig(iters=7, print_every=100, test_every=3)
    logger = MetricLogger(str(tmp_path))
    train_loop(_toy_state(), _toy_step, _batches, None, cfg, logger=logger,
               test_fn=lambda s, it: {"dev": float(it)}, callback=lambda s, it: seen.append(it))
    assert seen == [2, 5]
    assert logger.history("dev") == {2: 2.0, 6: 5.0}  # iteration 5 lands in the final window


def test_metric_logger_resume_preserves_history(tmp_path):
    """log.pkl is rewritten from the in-memory history on every flush, so a
    resumed process reloads the existing pickle."""
    d = str(tmp_path)
    lg = MetricLogger(d)
    for i in range(3):
        lg.plot("loss", float(i))
        lg.tick()
        lg.flush()
    lg2 = MetricLogger(d)
    lg2.set_iteration(3)
    lg2.plot("loss", 99.0)
    lg2.tick()
    lg2.flush()
    with open(tmp_path / "log.pkl", "rb") as f:
        hist = pickle.load(f)
    assert sorted(hist["loss"]) == [1, 2, 3, 4]
    assert hist["loss"][4] == 99.0


def test_log_pkl_is_read_across_packages(tmp_path):
    """JAX's ``logged_progress`` reads the port's ``log.pkl`` and the port's
    reads JAX's; each logger keeps the other's history on start."""
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    for logger_cls, d in ((MetricLogger, port_dir), (JaxMetricLogger, jax_dir)):
        lg = logger_cls(d)
        lg.set_iteration(40)
        lg.plot("loss", 1.5)
        lg.flush()
    assert jax_logged_progress(port_dir) == logged_progress(jax_dir) == 40
    assert JaxMetricLogger(port_dir).history("loss") == {40: 1.5}
    assert MetricLogger(jax_dir).history("loss") == {40: 1.5}


def test_print_std(capsys):
    lg = MetricLogger(print_std=True)
    lg.plot("loss", 1.0)
    lg.plot("loss", 3.0)
    assert lg.flush()["loss"] == 2.0
    assert "2.00000±1.00000" in capsys.readouterr().out


# ----------------------------------------------------------- resume safety


def _write_log(out_dir, upto, metric="loss"):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "log.pkl"), "wb") as f:
        pickle.dump({metric: {i: float(i) for i in range(1, upto + 1)}}, f)


def test_logged_progress(tmp_path):
    assert logged_progress(str(tmp_path)) == 0
    _write_log(str(tmp_path), 42)
    assert logged_progress(str(tmp_path)) == 42


def test_logged_progress_corrupt_pickle(tmp_path):
    (tmp_path / "log.pkl").write_bytes(b"not a pickle")
    assert logged_progress(str(tmp_path)) == 0


def test_reap_stale_tmps(tmp_path):
    (tmp_path / "tmpabc.npz.tmp").write_bytes(b"x" * 100)
    (tmp_path / "keep.npz").write_bytes(b"y")
    assert len(reap_stale_tmps(str(tmp_path))) == 1
    assert not (tmp_path / "tmpabc.npz.tmp").exists() and (tmp_path / "keep.npz").exists()


def test_guard_raises_on_silent_fresh_start(tmp_path):
    _write_log(str(tmp_path), 50)
    with pytest.raises(SystemExit, match="REFUSING"):
        guard_fresh_start(str(tmp_path), 0)


def test_guard_tolerance_covers_save_cadence(tmp_path):
    _write_log(str(tmp_path), 50)
    guard_fresh_start(str(tmp_path), 48, tolerance=5)
    with pytest.raises(SystemExit):
        guard_fresh_start(str(tmp_path), 40, tolerance=5)


def test_guard_explicit_overrides(tmp_path, monkeypatch):
    _write_log(str(tmp_path), 50)
    guard_fresh_start(str(tmp_path), 0, allow_fresh_start=True)
    monkeypatch.setenv("CTGAN_ALLOW_FRESH_START", "1")
    guard_fresh_start(str(tmp_path), 0)


def test_guard_clean_dir_is_free(tmp_path):
    guard_fresh_start(str(tmp_path), 0)


def test_ndjson_backfilled_from_pkl(tmp_path):
    _write_log(str(tmp_path), 5)
    MetricLogger(str(tmp_path))
    rows = [json.loads(line) for line in (tmp_path / "log.ndjson").read_text().splitlines()]
    assert [r["iteration"] for r in rows] == [1, 2, 3, 4, 5]
    assert all(r["backfilled"] and r["loss"] == r["iteration"] for r in rows)


def test_ndjson_behind_is_rebuilt(tmp_path):
    _write_log(str(tmp_path), 500)
    (tmp_path / "log.ndjson").write_text(
        "\n".join(json.dumps({"iteration": i, "loss": 0.0}) for i in range(1, 70)) + "\n")
    MetricLogger(str(tmp_path))
    rows = (tmp_path / "log.ndjson").read_text().splitlines()
    assert len(rows) == 500 and json.loads(rows[-1])["iteration"] == 500


def test_ndjson_current_untouched(tmp_path):
    _write_log(str(tmp_path), 3)
    orig = "\n".join(json.dumps({"iteration": i, "loss": float(i), "wall_time": 1.0})
                     for i in (1, 2, 3)) + "\n"
    (tmp_path / "log.ndjson").write_text(orig)
    MetricLogger(str(tmp_path))
    assert (tmp_path / "log.ndjson").read_text() == orig


def test_loop_refuses_to_start_behind_the_log(tmp_path):
    _write_log(str(tmp_path), 50)
    cfg = LoopConfig(iters=3, save_every=2, ckpt_dir=str(tmp_path / "ckpt"))
    with pytest.raises(SystemExit, match="REFUSING"):
        train_loop(_toy_state(), _toy_step, _batches, None, cfg, logger=MetricLogger(str(tmp_path)))


# ------------------------------------------------------------ the flagship app

SMALL = dict(DIM_G=16, DIM_D=16, BATCH_SIZE=4, N_CRITIC=2, n_examples=64, sample_every=100,
             INCEPTION_FREQUENCY=0, save_every=2)


def _cfg(tmp_path, **kw):
    return app.Config(**(SMALL | {"out_dir": str(tmp_path)} | kw))


def test_app_params_latest_fallback(tmp_path, capsys):
    """The checkpoint directory lost, ``params_latest.npz`` kept: the app
    resumes approximately (params exact, Adam fresh, step from the file)."""
    app.main(cfg=_cfg(tmp_path, ITERS=2), device="cpu")
    saved = state_to_jax(app.main(cfg=_cfg(tmp_path, ITERS=2), device="cpu")[0])
    assert os.path.exists(tmp_path / "params_latest.npz")
    shutil.rmtree(tmp_path / "ckpt")
    capsys.readouterr()
    state, records = app.main(cfg=_cfg(tmp_path, ITERS=4, save_every=100), device="cpu")
    out = capsys.readouterr().out
    assert "resumed (approximate)" in out and "at iteration 2" in out
    assert state.step == 4 and state.gen_opt["t"] == 2.0 and state.disc_opt["t"] == 4.0
    assert [r["iteration"] for r in records] == [2, 3]
    assert set(saved["gen_params"]) == set(state.gen_params)


def test_app_refuses_silent_fresh_start(tmp_path):
    app.main(cfg=_cfg(tmp_path, ITERS=6), device="cpu")
    shutil.rmtree(tmp_path / "ckpt")
    os.unlink(tmp_path / "params_latest.npz")
    with pytest.raises(SystemExit, match="REFUSING"):
        app.main(cfg=_cfg(tmp_path, ITERS=8), device="cpu")
    state, _ = app.main(cfg=_cfg(tmp_path, ITERS=1, allow_fresh_start=True), device="cpu")
    assert state.step == 1


def test_app_resumed_equals_uninterrupted(tmp_path, capsys):
    """6 iterations (checkpoints at 3 and 6, test_fn at 2 and 5) resumed to
    9 give exactly the state of 9 uninterrupted iterations on the CPU: the
    draws depend on (seed, step) only and a checkpoint holds the whole
    state.  ``DECAY`` is off because the LR schedule is a function of
    ``ITERS`` (in both packages)."""
    kw = dict(save_every=3, sample_every=3, DECAY=False)
    app.main(cfg=_cfg(tmp_path / "a", ITERS=6, **kw), device="cpu")
    capsys.readouterr()
    resumed, records = app.main(cfg=_cfg(tmp_path / "a", ITERS=9, **kw), device="cpu")
    assert f"resumed from {tmp_path / 'a' / 'ckpt' / 'ckpt_6.npz'} at iteration 6" in capsys.readouterr().out
    whole, _ = app.main(cfg=_cfg(tmp_path / "b", ITERS=9, **kw), device="cpu")
    got, want = state_to_jax(resumed), state_to_jax(whole)
    assert int(got["step"]) == int(want["step"]) == 9
    for field in ("gen_params", "disc_params", "gen_opt", "disc_opt"):
        for k, v in _flat(want[field]):
            np.testing.assert_array_equal(dict(_flat(got[field]))[k], v, err_msg=f"{field} {k}")
    assert sorted(os.listdir(tmp_path / "a")) == sorted(os.listdir(tmp_path / "b"))
    # the dev costs at 5 and 8: one window (5-8) uninterrupted, two windows
    # (the first run's last, the resumed run's) when resumed
    dev_a = MetricLogger(str(tmp_path / "a")).history("dev_cost")
    dev_b = MetricLogger(str(tmp_path / "b")).history("dev_cost")
    assert records[-1]["dev_cost"] == dev_a[8] and dev_a[2] == dev_b[2]
    assert (dev_a[5] + dev_a[8]) / 2 == pytest.approx(dev_b[8], rel=1e-6)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v
