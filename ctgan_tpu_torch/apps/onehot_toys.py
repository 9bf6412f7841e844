"""One-hot toy experiments (counterpart of ``ctgan_tpu/apps/onehot_toys.py``,
itself a rebuild of the reference's ``LSUN_bedrooms/wgan_onehots.py`` and
``onehot_autoencoder.py``).

* ``--which wgan``: a Gumbel-softmax one-hot WGAN.  G is an MLP over 128-d
  noise with multiplicative gates (``linear(x) * linear2(x)``, three of
  them), then the Gumbel softmax at temperature 0.1 with U[0.1, 0.99) noise
  over ``OUTPUT_DIM``-way one-hots; the critic an MLP with leaky ReLUs;
  WGAN-GP with lambda 10; TF-Adam 1e-4 (0.5, 0.9) on both nets; each
  iteration one D update, then one G update against the updated D.
* ``--which ae``: a linear 32-d bottleneck autoencoder over 256-way
  one-hots, softmax cross-entropy, 8 Adam steps per batch.

Parameters come from ``ParamInit(seed)`` in the JAX model's creation order,
so a seed gives the JAX package's weights.  Real batches are one-hots of
``np.random.default_rng(seed)``'s integers, as in the JAX app; noise, Gumbel
uniforms and GP alphas come from ``Randomness.for_step(i)`` (the port's draws,
not JAX's), passed to the steps as tensors so a test can inject JAX's.
Both toys print their costs through ``MetricLogger`` every 100 iterations.

    python -m ctgan_tpu_torch.apps.onehot_toys --which wgan   # or: ae
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..bridge import from_jax_params
from ..core import ParamInit, Randomness, split_params
from ..losses.gan import gradient_penalty, wgan_losses
from ..ops import leaky_relu, linear
from ..train.optim import Adam
from ..utils import MetricLogger
from . import common

__all__ = ["Config", "autoencoder", "init_params", "main", "onehot_critic", "onehot_generator"]

NOISE_DIM = 128
AE_DIM = 256  # the autoencoder's one-hot width (onehot_autoencoder.py)
AE_BOTTLENECK = 32
AE_STEPS = 8  # Adam steps per batch (disc_iters, onehot_autoencoder.py:76)
LAMBDA = 10.0
TEMPERATURE = 0.1


@dataclass(frozen=True)
class Config:
    which: str = "wgan"      # wgan | ae
    BATCH_SIZE: int = 128
    ITERS: int = 10000
    OUTPUT_DIM: int = 512
    DIM: int = 256
    seed: int = 0
    out_dir: str = "runs/onehot_toys"


def parse_config(argv=None) -> Config:
    return common.parse_config(Config, argv)


def init_params(cfg: Config) -> dict[str, np.ndarray]:
    """JAX-layout params of the chosen toy, in the JAX model's creation order."""
    init = ParamInit(cfg.seed)
    if cfg.which == "ae":
        init.linear("Discriminator.2", AE_DIM, AE_BOTTLENECK)
        init.linear("Discriminator.Out", AE_BOTTLENECK, AE_DIM)
        return init.params
    init.linear("Generator.1.Linear", NOISE_DIM, cfg.DIM)
    init.linear("Generator.2.Linear", cfg.DIM, cfg.DIM)
    for i in (3, 4, 5):
        init.linear(f"Generator.{i}.Linear", cfg.DIM, cfg.DIM)
        init.linear(f"Generator.{i}.Linear2", cfg.DIM, cfg.DIM)
    init.linear("Generator.Out", cfg.DIM, cfg.OUTPUT_DIM)
    init.linear("Discriminator.1.Linear", cfg.OUTPUT_DIM, cfg.DIM)
    init.linear("Discriminator.2.Linear", cfg.DIM, cfg.DIM)
    init.linear("Discriminator.Out", cfg.DIM, 1)
    return init.params


def _linear(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return linear(x, p[name + ".W"], p[name + ".b"])


def onehot_generator(p: dict, noise: torch.Tensor, gumbel_u: torch.Tensor) -> torch.Tensor:
    """Softmaxed one-hots ``[n, OUTPUT_DIM]`` from noise ``[n, 128]`` and
    Gumbel uniforms in [0.1, 0.99) of the output's shape
    (``ctgan_tpu/apps/onehot_toys.py:41-62``)."""
    out = torch.relu(_linear(p, "Generator.1.Linear", noise))
    out = torch.relu(_linear(p, "Generator.2.Linear", out))
    for i in (3, 4, 5):  # multiplicative gates
        out = _linear(p, f"Generator.{i}.Linear", out) * _linear(p, f"Generator.{i}.Linear2", out)
    logits = _linear(p, "Generator.Out", out)
    return torch.softmax((logits + -torch.log(-torch.log(gumbel_u))) / TEMPERATURE, dim=-1)


def onehot_critic(p: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(logits [n], features [n, DIM])``."""
    out = leaky_relu(_linear(p, "Discriminator.1.Linear", x))
    out = leaky_relu(_linear(p, "Discriminator.2.Linear", out))
    return _linear(p, "Discriminator.Out", out).reshape(-1), out


def autoencoder(p: dict, x: torch.Tensor) -> torch.Tensor:
    return _linear(p, "Discriminator.Out", _linear(p, "Discriminator.2", x))


def onehot_batch(rng: np.random.Generator, batch: int, dim: int) -> np.ndarray:
    return np.eye(dim, dtype="float32")[rng.integers(0, dim, size=batch)]


def wgan_draws(rand: Randomness, cfg: Config) -> dict[str, torch.Tensor]:
    """One iteration's draws: the D step's noise, Gumbel uniforms and GP
    alphas, then the G step's noise and Gumbel uniforms."""

    def gumbel_u() -> torch.Tensor:
        return 0.1 + 0.89 * rand.uniform(cfg.BATCH_SIZE, cfg.OUTPUT_DIM)

    return {"noise_d": rand.noise(cfg.BATCH_SIZE, NOISE_DIM), "u_d": gumbel_u(),
            "alpha": rand.gp_alpha(cfg.BATCH_SIZE),
            "noise_g": rand.noise(cfg.BATCH_SIZE, NOISE_DIM), "u_g": gumbel_u()}


def _value_and_grad(loss_fn, params: dict) -> tuple[torch.Tensor, dict]:
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


class WganToy:
    """G and D params (port layout, on one device), their TF-Adam states,
    and :meth:`step`."""

    def __init__(self, cfg: Config, device):
        params = {k: v.to(device) for k, v in from_jax_params(init_params(cfg)).items()}
        self.gen, self.disc, _ = split_params(params, "Generator", "Discriminator")
        self.opt_g, self.opt_d = Adam(1e-4, 0.5, 0.9), Adam(1e-4, 0.5, 0.9)
        self.sg, self.sd = self.opt_g.init(self.gen), self.opt_d.init(self.disc)

    def step(self, real: torch.Tensor, draws: dict, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """One D update, then one G update against the new D; returns
        ``(disc_cost, gen_cost)``."""
        with torch.no_grad():
            fake = onehot_generator(self.gen, draws["noise_d"], draws["u_d"])

        def d_loss(dp):
            _, cost = wgan_losses(onehot_critic(dp, real)[0], onehot_critic(dp, fake)[0])
            gpen, _ = gradient_penalty(lambda x: onehot_critic(dp, x)[0], real, fake, draws["alpha"])
            return cost + LAMBDA * gpen

        dc, dg = _value_and_grad(d_loss, self.disc)
        self.opt_d.update(dg, self.sd, self.disc, i)

        def g_loss(gp):
            fake = onehot_generator(gp, draws["noise_g"], draws["u_g"])
            return -onehot_critic(self.disc, fake)[0].float().mean()

        gc, gg = _value_and_grad(g_loss, self.gen)
        self.opt_g.update(gg, self.sg, self.gen, i)
        return dc, gc


class AeToy:
    """The autoencoder's params, its TF-Adam state and :meth:`step`."""

    def __init__(self, cfg: Config, device):
        self.params = {k: v.to(device) for k, v in from_jax_params(init_params(cfg)).items()}
        self.opt = Adam(1e-4, 0.5, 0.9)
        self.state = self.opt.init(self.params)

    def step(self, real: torch.Tensor, i: int) -> torch.Tensor:
        """One Adam step of the softmax cross-entropy; returns its cost."""

        def loss(p):
            return -(real * torch.log_softmax(autoencoder(p, real), dim=1)).sum(dim=1).mean()

        c, g = _value_and_grad(loss, self.params)
        self.opt.update(g, self.state, self.params, i)
        return c


def run_wgan(cfg: Config, logger: MetricLogger, device) -> WganToy:
    toy = WganToy(cfg, device)
    rng, rand = np.random.default_rng(cfg.seed), Randomness(cfg.seed, device)
    for i in range(cfg.ITERS):
        real = torch.from_numpy(onehot_batch(rng, cfg.BATCH_SIZE, cfg.OUTPUT_DIM)).to(device)
        dc, gc = toy.step(real, wgan_draws(rand.for_step(i), cfg), i)
        logger.plot("disc_cost", float(dc))
        logger.plot("gen_cost", float(gc))
        logger.tick()
        if i % 100 == 99:
            logger.flush()
    return toy


def run_ae(cfg: Config, logger: MetricLogger, device) -> AeToy:
    toy = AeToy(cfg, device)
    rng = np.random.default_rng(cfg.seed)
    for i in range(cfg.ITERS):
        real = torch.from_numpy(onehot_batch(rng, cfg.BATCH_SIZE, AE_DIM)).to(device)
        for _ in range(AE_STEPS):
            c = toy.step(real, i)
        logger.plot("disc_cost", float(c))
        logger.tick()
        if i % 100 == 99:
            logger.flush()
    return toy


def main(argv=None, cfg: Config | None = None, device="cuda"):
    """Train the toy ``cfg.which`` for ``cfg.ITERS`` iterations on
    ``device``; returns the toy (its params and optimiser states)."""
    cfg = cfg or parse_config(argv)
    if cfg.which not in ("wgan", "ae"):
        raise ValueError(f"unknown toy {cfg.which!r} (wgan | ae)")
    device = common.require_device(device)
    logger = MetricLogger(common.setup_out_dir(cfg))
    if cfg.which == "wgan":
        return run_wgan(cfg, logger, device)
    return run_ae(cfg, logger, device)


if __name__ == "__main__":
    main()
