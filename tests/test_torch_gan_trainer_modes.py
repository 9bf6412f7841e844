"""The modes without a gradient penalty of ``ctgan_tpu_torch``'s
unconditional GAN trainer against ``ctgan_tpu``'s on the CPU: ``wgan``
(RMSProp at 5e-5, D's weights clipped), ``dcgan`` (sigmoid cross-entropy,
Adam at 2e-4, per-element gradient clip) and ``lsgan`` (least squares,
RMSProp at 1e-4, G's batch twice the critic's), held as
``check_iterations`` in tests/test_torch_gan_trainer.py holds ``wgan-ct``
and ``wgan-gp``, with the same tolerances."""

from __future__ import annotations

import pytest

from test_torch_gan_trainer import check_iterations


@pytest.mark.parametrize("mode,extra", [
    ("wgan", {}),
    ("dcgan", dict(clip_grad_value=0.05)),
    ("lsgan", dict(gen_bs_multiple=2)),
])
def test_iterations_match_jax(mode, extra, monkeypatch):
    check_iterations(mode, extra, monkeypatch)
