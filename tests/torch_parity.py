"""Shared set-up for the tests that hold ``ctgan_tpu_torch`` against
``ctgan_tpu`` on the CPU.

JAX's ``jax.random`` and the port's generators cannot give the same numbers,
so the JAX side is made to draw from fixed sources while it is traced
(:class:`JaxDraws`) and the port is handed the same values
(:class:`InjectedRandomness`).  Everything runs in fp32 on the CPU.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
import torch

from ctgan_tpu.core import init_context, rng_context, split_params
from ctgan_tpu.core import rng as jax_rng
from ctgan_tpu.models import blocks as jax_blocks
from ctgan_tpu.models import resnet_cifar as jax_resnet
from ctgan_tpu.ops import dropout as jax_dropout

from ctgan_tpu_torch.bridge import from_jax_params
from ctgan_tpu_torch.models import resnet_cifar as port_resnet

KP = (0.8, 0.5, 0.5)

# The suite runs as several pytest-xdist workers on one host, beside JAX's
# own thread pools.  PyTorch's default of one intra-op thread per core in
# every worker oversubscribes the cores, and its spinning threads made the
# port's CPU tests many times slower than alone.  One thread per worker.
torch.set_num_threads(1)


def jax_model_cfg(dim: int):
    return jax_resnet.ResnetCifarConfig(dim_g=dim, dim_d=dim)


def port_model_cfg(dim: int, fuse_meanpool: bool = True):
    return port_resnet.ResnetCifarConfig(dim_g=dim, dim_d=dim, fuse_meanpool=fuse_meanpool)


def jax_init_params(dim: int, seed: int = 0) -> tuple[dict, dict]:
    """Fresh (gen, disc) params as the JAX flagship app creates them."""
    cfg = jax_model_cfg(dim)
    with init_context(seed=seed) as ctx:
        with rng_context(jax.random.PRNGKey(seed)):
            labels = jnp.zeros((2,), jnp.int32)
            jax_resnet.discriminator(jax_resnet.generator(2, labels, cfg=cfg), labels, *KP, cfg)
    gen, disc, rest = split_params(ctx.params, "Generator", "Discriminator")
    assert not rest
    return gen, disc


def to_port(params: dict, requires_grad: bool = True) -> dict[str, torch.Tensor]:
    out = from_jax_params({k: np.asarray(v) for k, v in params.items()})
    return {k: v.requires_grad_(requires_grad) for k, v in out.items()}


def nhwc_to_nchw(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))


class JaxDraws:
    """Patches the JAX model and trainer so that, while traced, they draw
    from fixed sources and record what they drew, in trace order:

    * dropout (``model.dropout``, the flagship's ``resnet_cifar`` unless
      another model module is given) takes the next of a fixed list of keys
      and runs the JAX package's own dropout with it;
    * latent noise (``model.noise_input``) is the next of a list of seeded
      NumPy normals;
    * ``rng.next_key`` (the trainer's "labels" and "gp" streams) returns the
      next fixed key of its stream.

    ``monkeypatch`` is pytest's fixture; the patches end with the test.
    """

    def __init__(self, monkeypatch, seed: int = 0, *, fuse_meanpool: bool = True, model=jax_resnet):
        self._keys = list(jax.random.split(jax.random.PRNGKey(seed), 256))
        self._np = np.random.default_rng(seed)
        self.dropouts: list[tuple] = []   # (key, nhwc shape, kp)
        self.noises: list[np.ndarray] = []
        self.stream_keys: dict[str, list] = {"labels": [], "gp": []}
        monkeypatch.setattr(model, "dropout", self._dropout)
        monkeypatch.setattr(model, "noise_input", self._noise_input)
        monkeypatch.setattr(jax_rng, "next_key", self._next_key)
        monkeypatch.setattr(jax_blocks, "FUSE_MEANPOOL_CONV", fuse_meanpool)

    def _take_key(self):
        return self._keys.pop(0)

    def _dropout(self, x, keep_prob, *, deterministic=False, **kw):
        if deterministic or (isinstance(keep_prob, (int, float)) and keep_prob >= 1.0):
            return x
        key = self._take_key()
        self.dropouts.append((key, tuple(x.shape), float(keep_prob)))
        return jax_dropout(x, keep_prob, key=key)

    def _noise_input(self, n_samples, dim=128, noise=None, stream="noise"):
        if noise is not None:
            return noise
        z = self._np.normal(size=(n_samples, dim)).astype(np.float32)
        self.noises.append(z)
        return jnp.asarray(z)

    def _next_key(self, stream="default"):
        key = self._take_key()
        self.stream_keys[stream].append(key)
        return key

    def masks(self) -> list[tuple[np.ndarray, float]]:
        """Each recorded dropout's keep mask (bool, NHWC) and keep prob, as
        the JAX CPU path draws it (``ctgan_tpu/ops/dropout.py:60-63``)."""
        return [
            (np.asarray(jax.random.uniform(k, shape, jnp.float32) < kp), kp)
            for k, shape, kp in self.dropouts
        ]

    def injected(self, dequant: list[np.ndarray] | None = None) -> "InjectedRandomness":
        return InjectedRandomness(
            masks=self.masks(), noises=list(self.noises),
            label_keys=list(self.stream_keys["labels"]),
            gp_keys=list(self.stream_keys["gp"]), dequant=list(dequant or []),
        )


class InjectedRandomness:
    """The port's randomness provider, handing out the JAX side's draws in
    order and checking that each request matches what was drawn."""

    def __init__(self, *, masks=(), noises=(), label_keys=(), gp_keys=(), dequant=()):
        self._masks, self._noises = list(masks), list(noises)
        self._label_keys, self._gp_keys = list(label_keys), list(gp_keys)
        self._dequant = list(dequant)

    def exhausted(self) -> bool:
        return not (self._masks or self._noises or self._label_keys or self._gp_keys or self._dequant)

    def noise(self, n, dim):
        z = self._noises.pop(0)
        assert z.shape == (n, dim)
        return torch.from_numpy(z)

    def labels(self, n, n_labels):
        key = self._label_keys.pop(0)
        return torch.from_numpy(np.array(jax.random.randint(key, (n,), 0, n_labels), dtype=np.int64))

    def gp_alpha(self, n):
        key = self._gp_keys.pop(0)
        return torch.from_numpy(np.array(jax.random.uniform(key, (n, 1), jnp.float32)))

    def dequant(self, shape):
        u = self._dequant.pop(0)
        assert u.shape == tuple(shape)
        return torch.from_numpy(u)

    def dropout_mask(self, shape, keep_prob, dtype, device):
        keep, kp = self._masks.pop(0)
        assert kp == keep_prob
        keep = nhwc_to_nchw(keep)
        assert keep.shape == tuple(shape), (keep.shape, shape)
        mask = np.where(keep, np.float32(1.0 / kp), np.float32(0.0))
        return torch.from_numpy(mask).to(device=device, dtype=dtype)


def dequant_draws(base_key, step: int, n_critic: int, shape) -> list[np.ndarray]:
    """The dequantisation noise of ``critic_substep`` i at ``step``
    (ctgan_tpu/train/trainer_acgan.py:224-228)."""
    key = jax.random.fold_in(base_key, step)
    return [
        np.array(jax.random.uniform(jax.random.fold_in(key, 5000 + i), shape, maxval=1.0 / 128))
        for i in range(n_critic)
    ]


def assert_grads_close(jax_grads: dict, port_grads: dict, what: str, rtol: float = 1e-3):
    """Every parameter gradient, port (OIHW, converted back) against JAX.
    The scale of each tensor is its largest gradient, floored at 1% of the
    largest gradient anywhere, so that a gradient that is zero up to
    rounding (a bias feeding a batch norm) is not judged by its noise."""
    from ctgan_tpu_torch.bridge import to_jax_params

    port_np = to_jax_params(port_grads)
    assert set(port_np) == set(jax_grads), what
    global_scale = max(float(np.max(np.abs(np.asarray(g)))) for g in jax_grads.values())
    for name, jg in jax_grads.items():
        jg = np.asarray(jg, np.float64)
        pg = port_np[name].astype(np.float64)
        assert jg.shape == pg.shape, (name, jg.shape, pg.shape)
        scale = max(float(np.max(np.abs(jg))), 1e-2 * global_scale)
        dev = float(np.max(np.abs(jg - pg))) / scale
        assert dev < rtol, f"{what}: {name} grad deviates {dev:.2e} (scale {scale:.2e})"
