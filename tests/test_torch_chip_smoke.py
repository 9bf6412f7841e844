"""Rehearsal of ``chip_smoke.py`` and the port's flagship app on the CPU:
the phases that drive the trainer run here at dim 16 with the kernel's
plain version; the script's ``main`` refuses to run without a card."""

from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch

from ctgan_tpu_torch.apps import ct_gan_cifar_resnet as app
from ctgan_tpu_torch.core import compute_dtype
from ctgan_tpu_torch.kernels import dropout_mask

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _small_cfg(tmp_path, **kw):
    args = dict(ITERS=3, DIM_G=16, DIM_D=16, BATCH_SIZE=4, N_CRITIC=2, n_examples=64,
                out_dir=str(tmp_path))
    return app.Config(**(args | kw))


def test_cuda_vs_cpu_phase_rehearses_on_cpu():
    assert _chip_smoke().phase_cuda_vs_cpu("cpu") == 0.0


def test_train_phase_rehearses_on_cpu(tmp_path):
    out = _chip_smoke().phase_train("cpu", _small_cfg(tmp_path))
    assert out["launches"] == 0  # the wrapper counts CUDA launches only
    assert out["last"]["iteration"] == 2 and out["peak_bytes"] is None
    logged = [json.loads(line) for line in (tmp_path / "log.ndjson").read_text().splitlines()]
    assert [r["iteration"] for r in logged] == [0, 1, 2]
    assert all(math.isfinite(r[k]) for r in logged for k in ("wgan", "ct", "gp", "acgan", "gen_cost"))


def test_flagship_masks_per_iteration():
    """33 launches and about 42.5 M mask elements per 1G+5D iteration."""
    shapes = _chip_smoke().flagship_mask_shapes()
    assert shapes == [(128, 128, 8, 8), (256, 128, 8, 8), (64, 128, 8, 8)]
    g, pair, gp = (math.prod(s) for s in shapes)
    assert 3 * g + 5 * 3 * (pair + gp) == 42_467_328


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert _chip_smoke().main() == 1
    assert capsys.readouterr().out == ""


def test_app_refuses_what_the_slice_lacks(tmp_path):
    """Without a card the app refuses to start on cuda.  ``BF16`` and
    ``NORMALIZATION_D``, which earlier slices refused, now train: ``BF16``
    on the CPU runs fp32, as the JAX app does off the accelerator."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            app.main(cfg=_small_cfg(tmp_path))
    _, records = app.main(cfg=_small_cfg(tmp_path / "bf16", ITERS=1, BF16=True), device="cpu")
    assert compute_dtype() == torch.float32 and math.isfinite(records[-1]["gp"])
    state, records = app.main(cfg=_small_cfg(tmp_path / "norm_d", ITERS=1, NORMALIZATION_D=True),
                              device="cpu")
    assert state.disc_params["Discriminator.2.N1.scale"].shape == (16,)
    assert math.isfinite(records[-1]["gp"])


def test_cli_flags_are_the_config_fields():
    cfg = app.parse_config(["--ITERS", "7", "--FUSE_MEANPOOL", "false", "--LR", "1e-3"])
    assert (cfg.ITERS, cfg.FUSE_MEANPOOL, cfg.LR, cfg.DIM_G) == (7, False, 1e-3, 128)
    assert app.Config().CUDA_DROPOUT and app.Config().BF16
    assert not app.parse_config(["--BF16", "0"]).BF16


@pytest.mark.parametrize("fuse_meanpool,fuse_ct,clean_pass", [
    (False, True, True), (True, False, False),
])
def test_app_arms_train_on_cpu(tmp_path, fuse_meanpool, fuse_ct, clean_pass):
    cfg = _small_cfg(tmp_path, ITERS=2, FUSE_MEANPOOL=fuse_meanpool, FUSE_CT_PASSES=fuse_ct,
                     CLEAN_PASS=clean_pass, CUDA_DROPOUT=False)
    before = dropout_mask.launches
    _, records = app.main(cfg=cfg, device="cpu")
    assert dropout_mask.launches == before
    assert ("acc_real" in records[-1]) == clean_pass
