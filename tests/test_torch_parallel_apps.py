"""The flagship app and ``generate`` over 2 gloo processes on the CPU
(``apps.common.maybe_mesh`` on a spawned group, ``tests/torch_parallel_workers.py``):
checkpoints with full leaves that the JAX package's loader reads, resume
at another number of processes, rank 0 alone logging and writing.

Tolerances: the 2-rank run against 1 process, rtol 2e-4 and atol 2e-5 on
every parameter and Adam moment, except where a TF-Adam step's sign is
decided by rounding (``tests/test_torch_parallel.py``'s rule: the leaves
with a gradient zero up to rounding anywhere, other leaves at 0.1% of
their elements per update, each within 2 * lr per update); logged metrics
rtol 1e-4 with that bound as their absolute slack (the critic's output bias
is such a leaf).  Over three iterations those steps move the later
gradients too (TF-Adam with beta1 0: G's first moment is its last
gradient), so the Adam moments are held to 0.5% of each tensor's scale.
Generated images 1e-5 (G's batch norms summed over two ranks).
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

from ctgan_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint

from ctgan_tpu_torch.apps import ct_gan_cifar_resnet as app
from ctgan_tpu_torch.apps import generate
from ctgan_tpu_torch.models import resnet_cifar
from ctgan_tpu_torch.utils import MetricLogger, load_checkpoint

import torch_parallel_workers as workers
from test_torch_parallel import assert_states_close

DIM = 16
ITERS = 3
LR = 2e-4  # the flagship's Adam
UPDATES = (ITERS - 1) + 2 * ITERS  # G's updates (step 0's is dropped), D's (two critic substeps each)
STEP_BOUND = 2 * LR * UPDATES
MOMENT_SCALE_RTOL = 5e-3
CFG = dict(ITERS=ITERS, DIM_G=DIM, DIM_D=DIM, BATCH_SIZE=4, N_CRITIC=2, n_examples=256, sample_every=ITERS,
           save_every=1, INCEPTION_FREQUENCY=0, DECAY=False)
GEN = dict(dim=DIM, batch=8, n=16)


def _cfg(out_dir, **kw) -> dict:
    return CFG | {"out_dir": str(out_dir)} | kw


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """2 ranks with ``MODEL_AXIS`` 2 for ``ITERS`` iterations (a checkpoint
    after each), then ``generate`` over the 2 ranks on the checkpoint at 2;
    1 process for ``ITERS`` iterations straight; 1 process resumed from the
    2-rank checkpoint at 2 to ``ITERS``."""
    tmp = tmp_path_factory.mktemp("apps")
    two = tmp / "two"
    ckpt2 = two / "ckpt" / "ckpt_2.npz"
    group = workers.run_group(2, [
        ("flagship_main", dict(cfg=_cfg(two, MODEL_AXIS=2))),
        ("generate_main", dict(cfg=GEN | dict(ckpt=str(ckpt2), out_prefix=str(tmp / "gen2")))),
        ("chip_lockstep", {}),
    ], tmp / "group")
    workers.small_flagship_data()  # this process draws the same small set
    for name in ("one", "resumed"):
        (tmp / name).mkdir()
        shutil.copy(two / "scorer.npz", tmp / name / "scorer.npz")  # the scorer two's rank 0 fitted
    one_state, one_records = app.main(cfg=app.Config(**_cfg(tmp / "one")), device="cpu")
    (tmp / "resumed" / "ckpt").mkdir()
    shutil.copy(ckpt2, tmp / "resumed" / "ckpt" / "ckpt_2.npz")
    resumed_state, _ = app.main(cfg=app.Config(**_cfg(tmp / "resumed")), device="cpu")
    gen1 = generate.main(cfg=generate.Config(**GEN, ckpt=str(ckpt2), out_prefix=str(tmp / "gen1")), device="cpu")
    return dict(tmp=tmp, group=group, one=one_records, gen1=gen1)


def _state(path) -> dict:
    return load_checkpoint(str(path))["state"]


def test_two_ranks_store_shards_and_train_as_one_process(runs):
    """The 2-rank run (``data 1 x model 2``) stores G's input projection in
    halves, and its checkpoint at ``ITERS`` equals the one-process run's."""
    stored = runs["group"][0]["flagship_main"]["stored"]
    full = _state(runs["tmp"] / "one" / "ckpt" / f"ckpt_{ITERS}.npz")
    assert stored["Generator.Input.W"] == (full["gen_params"]["Generator.Input.W"].shape[1] // 2,
                                           full["gen_params"]["Generator.Input.W"].shape[0])
    got = _state(runs["tmp"] / "two" / "ckpt" / f"ckpt_{ITERS}.npz")
    zero_grad = resnet_cifar.zero_grad_params(resnet_cifar.ResnetCifarConfig(dim_g=DIM, dim_d=DIM))
    assert_states_close(got, full, zero_grad, STEP_BOUND, moment_scale_rtol=MOMENT_SCALE_RTOL)
    assert int(got["step"]) == int(full["step"]) == ITERS


def test_checkpoint_of_two_ranks_reads_in_jax_and_resumes_on_one(runs):
    """The 2-rank checkpoint holds full leaves in the JAX format (the JAX
    package's loader reads every leaf at the one-process shapes); resumed on
    1 process for the last iteration it equals ``ITERS`` straight
    iterations on 1 process."""
    tmp = runs["tmp"]
    blob = jax_load_checkpoint(str(tmp / "two" / "ckpt" / "ckpt_2.npz"))
    want = _state(tmp / "one" / "ckpt" / "ckpt_2.npz")
    for field in ("gen_params", "disc_params"):
        assert {k: np.shape(v) for k, v in blob["state"][field].items()} == {
            k: v.shape for k, v in want[field].items()}
    for moment in ("m", "v"):
        assert {k: np.shape(v) for k, v in blob["state"]["gen_opt"][moment].items()} == {
            k: v.shape for k, v in want["gen_opt"][moment].items()}
    assert int(blob["loop"]["iteration"]) == 2 and blob["data_state"] == {"i": 2}
    zero_grad = resnet_cifar.zero_grad_params(resnet_cifar.ResnetCifarConfig(dim_g=DIM, dim_d=DIM))
    assert_states_close(_state(tmp / "resumed" / "ckpt" / f"ckpt_{ITERS}.npz"),
                        _state(tmp / "one" / "ckpt" / f"ckpt_{ITERS}.npz"), zero_grad, STEP_BOUND,
                        moment_scale_rtol=MOMENT_SCALE_RTOL)


def test_rank0_alone_logs_and_writes(runs):
    """One log row per flush, rank 0's; the evaluation (dev cost at
    ``ITERS - 1``) ran on rank 0 with the gathered parameters and equals
    the one-process one; rank 1 logged nothing to disk."""
    tmp = runs["tmp"]
    rank0 = runs["group"][0]["flagship_main"]["records"]
    rows = MetricLogger(str(tmp / "two")).history("disc_cost")
    assert sorted(rows) == [r["iteration"] for r in rank0] == [r["iteration"] for r in runs["one"]]
    lines = (tmp / "two" / "log.ndjson").read_text().splitlines()
    assert len(lines) == len(rank0)
    assert "dev_cost" in rank0[-1] and "dev_cost" not in runs["group"][1]["flagship_main"]["records"][-1]
    for got, want in zip(rank0, runs["one"]):
        for k in ("disc_cost", "gen_cost", "wgan", "dev_cost"):
            if k in want:
                assert np.isclose(got[k], want[k], rtol=1e-4, atol=STEP_BOUND), (k, got[k], want[k])
    assert sorted(os.listdir(tmp / "two" / "ckpt")) == sorted(os.listdir(tmp / "one" / "ckpt"))
    assert sorted(p for p in os.listdir(tmp / "two") if p.endswith(".png")) == ["samples_2.png"]


def test_generate_over_two_ranks_equals_one(runs):
    """``generate`` at batch 8 over 2 ranks: each makes its 4 rows of every
    request, G's batch norms over the 8; rank 0's gathered samples (and
    grid) equal the one-process samples."""
    got = runs["group"][0]["generate_main"]["samples"]
    assert got.shape == runs["gen1"].shape == (GEN["n"], 3 * 32 * 32)
    np.testing.assert_allclose(got, runs["gen1"], rtol=0, atol=1e-5)
    assert os.path.exists(runs["tmp"] / "gen2.png")


def test_generate_refuses_aot_over_ranks(tmp_path):
    """``--aot``/``--aot_save`` are single-device: refused over a mesh, as
    the JAX app refuses them (``ctgan_tpu/apps/generate.py:319-321``)."""
    out = workers.run_group(2, [("generate_refusal", dict(cfg=dict(GEN, aot_save=str(tmp_path / "a.pt2"))))],
                            tmp_path / "group")
    assert all("AOT serving artifacts are single-device" in r["generate_refusal"] for r in out)


def test_chip_lockstep_rehearses_on_cpu(runs):
    """``chip_smoke.py``'s substep-by-substep check of ``dp_two_ranks`` on 2
    gloo ranks on the CPU at dim 16: the mesh substeps within its bf16
    bounds of the one-process substeps (here fp32: far inside), both ranks
    the same report."""
    reports = [r["chip_lockstep"] for r in runs["group"]]
    assert not reports[0]["failures"] and reports[0]["total"] > 0
    assert reports[0]["grad_l1"] < 1e-3 and reports[0]["diff"] <= 2 * LR * 2 + 1e-6
    assert reports[1]["diff"] == reports[0]["diff"]
