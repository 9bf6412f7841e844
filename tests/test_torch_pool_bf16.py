"""``ctgan_tpu_torch``'s ``ops.space_to_depth`` and
``core.matmul.keep_bf16_activations`` against ``ctgan_tpu``'s on the CPU,
and the apps' ``--PALLAS_DROPOUT`` flag.

Tolerances:

* ``space_to_depth``: exact (a permutation), against JAX with NHWC
  converted to NCHW, and as the inverse of ``depth_to_space``.
* bf16 products and convolutions (linear, conv2d, the TF-SAME transposed
  conv) and the flagship G at dim 16, port against JAX, both under the
  bf16 policy with the switch on and off: ``4 U`` of the reference's
  largest magnitude, ``U = 2**-8`` (``tests/test_torch_bf16.py``: both
  round at the same points and differ in the order of fp32 sums).  The
  output dtypes equal JAX's.  Port against port: the ``False`` result is
  the ``True`` result cast to fp32, exactly.

Both switches and both precision policies are process-wide; a fixture
restores them after every test.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ctgan_tpu import ops as jax_ops
from ctgan_tpu.core import apply_context, default_tpu_policy, init_context, rng_context
from ctgan_tpu.core import matmul as jax_matmul
from ctgan_tpu.models import resnet_cifar as jax_resnet
from ctgan_tpu.ops import conv as jax_conv
from ctgan_tpu.ops import pool as jax_pool

from ctgan_tpu_torch import ops as port_ops
from ctgan_tpu_torch.apps import common
from ctgan_tpu_torch.apps import ct_cifar_ssl, ct_gan_64x64, ct_gan_cifar, ct_gan_cifar_resnet, ct_gan_mnist, wgan_lsun128
from ctgan_tpu_torch.core import default_policy, precision_policy
from ctgan_tpu_torch.core.matmul import keep_bf16_activations
from ctgan_tpu_torch.models import resnet_cifar as port_resnet

from torch_parity import JaxDraws, jax_init_params, jax_model_cfg, nhwc_to_nchw, port_model_cfg, to_port

U = 2.0 ** -8
DIM, BATCH = 16, 4


@pytest.fixture(autouse=True)
def _restore_switches():
    try:
        yield
    finally:
        keep_bf16_activations(True)
        jax_matmul.keep_bf16_activations(True)
        default_policy(False)
        default_tpu_policy(False)


def _max_dev(got, want) -> float:
    got = (got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64))
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


# ------------------------------------------------------------------ space_to_depth

@pytest.mark.parametrize("block,shape", [(2, (2, 4, 6, 3)), (2, (1, 8, 8, 5)), (4, (2, 8, 4, 2))])
def test_space_to_depth_equals_jax(block, shape):
    x = np.random.default_rng(block).normal(size=shape).astype(np.float32)
    want = nhwc_to_nchw(np.asarray(jax_pool.space_to_depth(jnp.asarray(x), block)))
    got = port_ops.space_to_depth(torch.from_numpy(nhwc_to_nchw(x)), block)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("block", [2, 3])
def test_space_to_depth_inverts_depth_to_space(block):
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 4, 3 * block, 2 * block)).astype(np.float32))
    y = port_ops.space_to_depth(x, block)
    assert y.shape == (2, 4 * block * block, 3, 2)
    assert torch.equal(port_ops.depth_to_space(y, block), x)
    assert torch.equal(port_ops.space_to_depth(port_ops.depth_to_space(y, block), block), y)
    # TF's channel order, not pixel_unshuffle's
    assert not torch.equal(y, torch.nn.functional.pixel_unshuffle(x, block))


# ------------------------------------------------------------------ keep_bf16_activations

def _jax_case(name: str, x):
    if name == "linear":
        return jax_ops.linear("L", x.shape[-1], 6, x)
    if name == "conv2d":
        return jax_ops.conv2d("C", x.shape[-1], 6, 3, x)
    return jax_conv.deconv2d("T", x.shape[-1], 6, 3, x)


def _port_case(name: str, p: dict, x):
    if name == "linear":
        return port_ops.linear(x, p["L.W"], p["L.b"])
    if name == "conv2d":
        return port_ops.conv2d(x, p["C.Filters"], p["C.Biases"])
    return port_ops.deconv2d(x, p["T.Filters"], p["T.Biases"])


@pytest.mark.parametrize("keep", [True, False])
@pytest.mark.parametrize("name", ["linear", "conv2d", "deconv2d"])
def test_bf16_products_under_both_settings_equal_jax(name, keep):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 8) if name == "linear" else (2, 5, 5, 4)).astype(np.float32)
    with init_context(seed=1) as ctx:
        _jax_case(name, jnp.asarray(x))
    jparams = {k: v + 0.1 if k.endswith(("b", "Biases")) else v for k, v in ctx.params.items()}
    default_tpu_policy(True)
    jax_matmul.keep_bf16_activations(keep)
    with apply_context(jparams):
        want = _jax_case(name, jnp.asarray(x))
    keep_bf16_activations(keep)
    xt = torch.from_numpy(x if x.ndim == 2 else nhwc_to_nchw(x))
    with precision_policy("bfloat16"):
        got = _port_case(name, to_port(jparams, False), xt)
    assert _dtype(got) == str(want.dtype) == ("bfloat16" if keep else "float32")
    want = np.asarray(want.astype(jnp.float32))
    assert _max_dev(got, want if want.ndim == 2 else nhwc_to_nchw(want)) <= 4 * U


@pytest.mark.parametrize("op", ["matmul", "conv", "conv_transpose"])
def test_false_returns_the_bf16_result_cast_to_fp32(op):
    """Port against port: under ``False`` the same bf16-rounded values, as
    fp32, exactly."""
    from ctgan_tpu_torch.core import matmul as port_matmul

    rng = np.random.default_rng(5)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x, w = {"matmul": (t(3, 8), t(6, 8)), "conv": (t(2, 4, 5, 5), t(6, 4, 3, 3)),
            "conv_transpose": (t(2, 4, 5, 5), t(4, 6, 3, 3))}[op]
    kw = {"conv": dict(padding=1), "conv_transpose": dict(stride=2, padding=1)}.get(op, {})
    fn = getattr(port_matmul, op)
    with precision_policy("bfloat16"):
        on = fn(x, w, **kw)
        keep_bf16_activations(False)
        off = fn(x, w, **kw)
    assert on.dtype == torch.bfloat16 and off.dtype == torch.float32
    assert torch.equal(off, on.float())


def test_flagship_generator_with_fp32_activations_equals_jax(monkeypatch):
    """The flagship G at dim 16 under the bf16 policy with the switch off in
    both packages: the same dtypes out, within ``4 U``."""
    JaxDraws(monkeypatch)
    gen, _ = jax_init_params(DIM, seed=11)
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 10, size=(BATCH,)).astype(np.int32)
    noise = rng.normal(size=(BATCH, 128)).astype(np.float32)
    default_tpu_policy(True)
    jax_matmul.keep_bf16_activations(False)
    with rng_context(jax.random.PRNGKey(0)), apply_context(gen):
        want = jax_resnet.generator(BATCH, jnp.asarray(labels), noise=jnp.asarray(noise), cfg=jax_model_cfg(DIM))
    keep_bf16_activations(False)
    with precision_policy("bfloat16"):
        got = port_resnet.generator(to_port(gen, False), BATCH, torch.from_numpy(labels).long(),
                                    port_model_cfg(DIM), None, noise=torch.from_numpy(noise))
    assert _dtype(got) == str(want.dtype)
    assert _max_dev(got, np.asarray(want.astype(jnp.float32))) <= 4 * U


def test_switch_is_restored_in_finally():
    """A caller that turns the switch off restores it in ``finally``; an
    error inside does not leave fp32 activations behind."""
    x, w = torch.ones(2, 3), torch.ones(4, 3)
    with pytest.raises(RuntimeError, match="inside"):
        keep_bf16_activations(False)
        try:
            raise RuntimeError("inside")
        finally:
            keep_bf16_activations(True)
    with precision_policy("bfloat16"):
        assert port_ops.linear(x, w, torch.zeros(4)).dtype == torch.bfloat16


# ------------------------------------------------------------------ --PALLAS_DROPOUT

APPS = [ct_gan_cifar_resnet, ct_gan_64x64, ct_gan_mnist, ct_gan_cifar, wgan_lsun128]


@pytest.mark.parametrize("app", APPS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_pallas_dropout_is_an_alias_of_cuda_dropout(app):
    """``docs/MIGRATION.md``'s ``--PALLAS_DROPOUT false`` sets the port's
    ``CUDA_DROPOUT``; ``--CUDA_DROPOUT`` still works; nothing else moves."""
    default = common.parse_config(app.Config, [])
    assert default.CUDA_DROPOUT is True
    off = common.parse_config(app.Config, ["--PALLAS_DROPOUT", "false"])
    assert off == dataclasses.replace(default, CUDA_DROPOUT=False)
    assert common.parse_config(app.Config, ["--CUDA_DROPOUT", "0"]) == off
    assert common.parse_config(app.Config, ["--PALLAS_DROPOUT", "1"]) == default


def test_pallas_dropout_is_refused_where_there_is_no_dropout_switch():
    assert not hasattr(ct_cifar_ssl.Config, "CUDA_DROPOUT")
    with pytest.raises(SystemExit):
        common.parse_config(ct_cifar_ssl.Config, ["--PALLAS_DROPOUT", "false"])
