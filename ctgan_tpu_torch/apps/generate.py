"""Sample generation from a trained checkpoint, the serving path
(counterpart of ``ctgan_tpu/apps/generate.py``), for ``--model
cifar_resnet`` (the flagship), ``good64`` (the 64 px "Good" ResNet),
``mnist`` and ``cifar`` (the paper's conv generators) and ``lsun128`` (the
128 px LSUN ResNet at its default widths, ``--dim`` unused, as in the JAX
app).

    python -m ctgan_tpu_torch.apps.generate --ckpt runs/ct_gan_cifar_resnet/ckpt/ckpt_1000.npz --n 100
    python -m ctgan_tpu_torch.apps.generate --model good64 --ckpt runs/good64_r5/params_latest.npz
    python -m ctgan_tpu_torch.apps.generate --model mnist --ckpt runs/ct_gan_mnist/params_latest.npz
    python -m ctgan_tpu_torch.apps.generate --model lsun128 --ckpt runs/wgan_lsun128/params_latest.npz
    python -m ctgan_tpu_torch.apps.generate --batch 1024 --serve_iters 50

``--ckpt`` takes a checkpoint of either package's train loop (or a
``params_latest.npz``, or a plain param dict).  ``--bf16`` runs G under the
bf16 precision policy, else under fp32, as the JAX app's ``_apply_call``
does (``ctgan_tpu/apps/generate.py:109-117``); samples leave the device as
fp32 either way.  ``--dim`` is G's width; for ``good64`` and ``mnist`` the
default 128 means 64, as in the JAX app (``ctgan_tpu/apps/generate.py:61-96``);
``mnist`` is the wgan-CT G (no batch norm), as there.  Samples are in
[0, 1] for ``mnist`` and [-1, 1] for the others.
Samples are made in batches of ``--batch`` (with random labels for
``cifar_resnet``); G's batch norm uses each batch's statistics, so the
batch size is part of the result.  The first 100 go to
``<out_prefix>.png``; ``--save_npz`` also writes them all to
``<out_prefix>.npz``.  ``--serve_iters N`` times N batches with CUDA events
(fresh weights when no ``--ckpt`` is given: the same compute) and prints
one JSON line with the JAX app's keys.

Not ported yet, and refused: ``--aot``/``--aot_save`` (ROADMAP Queue 1
item 12b).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..bridge import from_jax_params
from ..core import Randomness, precision_policy, split_params
from ..models import dcgan, good64, lsun128, resnet_cifar
from ..utils.checkpoint import load_checkpoint
from .common import parse_config, require_device, save_sample_grid

__all__ = ["Config", "load_gen_params", "main"]


@dataclass(frozen=True)
class Config:
    model: str = "cifar_resnet"
    ckpt: str = ""
    n: int = 100
    batch: int = 100
    seed: int = 0
    out_prefix: str = "generated"
    save_npz: bool = False
    dim: int = 128
    serve_iters: int = 0
    bf16: bool = False
    aot_save: str = ""
    aot: str = ""


LSUN128 = lsun128.Lsun128Config()  # the JAX app serves the default widths

_SHAPES = {"cifar_resnet": (3, 32, 32), "good64": (3, 64, 64), "mnist": (1, 28, 28), "cifar": (3, 32, 32),
           "lsun128": (3, 128, 128)}


def _check_supported(cfg: Config) -> None:
    if cfg.model not in _SHAPES:
        raise ValueError(f"unknown model {cfg.model!r}")
    if cfg.aot or cfg.aot_save:
        raise NotImplementedError("--aot/--aot_save are not ported yet: ROADMAP Queue 1 item 12b "
                                  "(serving ahead-of-time, CUDA graphs or torch.export)")


def load_gen_params(ckpt_path: str) -> dict[str, np.ndarray]:
    """Generator params, JAX layout, from a train-loop checkpoint of either
    package, a ``params_latest.npz``, or a plain param dict."""
    blob = load_checkpoint(ckpt_path)
    if "state" in blob and "gen_params" in blob["state"]:
        return dict(blob["state"]["gen_params"])
    if "params" in blob and "gen_params" in blob["params"]:
        return dict(blob["params"]["gen_params"])
    if "gen_params" in blob:
        return dict(blob["gen_params"])
    return {k: v for k, v in blob.items() if hasattr(v, "shape")}


def _width_64(cfg: Config) -> int:
    """G's width for ``good64`` and ``mnist``: ``--dim``, but 64 for the
    default 128."""
    return 64 if cfg.dim == 128 else cfg.dim


def _value_range(cfg: Config) -> tuple[float, float]:
    return (0.0, 1.0) if cfg.model == "mnist" else (-1.0, 1.0)


def _gen_params(cfg: Config, device) -> dict[str, torch.Tensor]:
    if cfg.ckpt:
        params = load_gen_params(cfg.ckpt)
    elif cfg.model == "good64":
        params = split_params(good64.init_params(_width_64(cfg), seed=cfg.seed), "Generator")[0]
    elif cfg.model in ("mnist", "cifar"):
        dim = _width_64(cfg) if cfg.model == "mnist" else cfg.dim
        params = split_params(dcgan.init_params(cfg.model, dim, seed=cfg.seed), "Generator")[0]
    elif cfg.model == "lsun128":
        params = split_params(lsun128.init_params(LSUN128, seed=cfg.seed), "Generator")[0]
    else:
        mcfg = resnet_cifar.ResnetCifarConfig(dim_g=cfg.dim, dim_d=cfg.dim)
        params = split_params(resnet_cifar.init_params(mcfg, cfg.seed), "Generator")[0]
    return {k: v.to(device) for k, v in from_jax_params(params).items()}


def _sampler(cfg: Config, params: dict, device):
    """``call(n, seed) -> [n, C*H*W]`` images (bf16 under ``--bf16``),
    noise (and labels) drawn from ``seed``."""
    mcfg = resnet_cifar.ResnetCifarConfig(dim_g=cfg.dim, dim_d=cfg.dim)

    def body(n: int, rand: Randomness) -> torch.Tensor:
        if cfg.model == "good64":
            return good64.generator(params, n, rand, dim=_width_64(cfg))
        if cfg.model == "mnist":
            return dcgan.mnist_generator(params, n, rand, dim=_width_64(cfg))
        if cfg.model == "cifar":
            return dcgan.cifar_generator(params, n, rand, dim=cfg.dim)
        if cfg.model == "lsun128":
            return lsun128.generator(params, n, rand, cfg=LSUN128)
        return resnet_cifar.generator(params, n, rand.labels(n, mcfg.n_labels), mcfg, rand)

    @torch.no_grad()
    def call(n: int, seed: int) -> torch.Tensor:
        with precision_policy("bfloat16" if cfg.bf16 else "float32"):
            return body(n, Randomness(seed, device))

    return call


def _serve_bench(cfg: Config, call, device) -> dict:
    """``serve_iters`` requests of ``batch`` images queued back to back and
    timed with CUDA events (device time per batch), after two warm-up
    requests; then one request timed on the host clock, synchronised."""
    if device.type != "cuda":
        raise RuntimeError("--serve_iters measures the card: it needs a CUDA device")
    k = max(cfg.serve_iters, 10)
    t_c = time.perf_counter()
    for i in range(2):
        call(cfg.batch, cfg.seed + i)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_c
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(k):
        call(cfg.batch, cfg.seed + 10 + i)
    end.record()
    end.synchronize()
    sec_per_batch = start.elapsed_time(end) / 1e3 / k
    t0 = time.perf_counter()
    call(cfg.batch, cfg.seed + 7)
    torch.cuda.synchronize()
    latency_s = time.perf_counter() - t0
    result = {
        "metric": f"{cfg.model}_gen_samples_per_sec_per_chip",
        "value": round(cfg.batch / sec_per_batch, 2),
        "unit": "images/sec/chip",
        "vs_baseline": None,
        "batch": cfg.batch,
        "sec_per_batch": round(sec_per_batch, 6),
        "request_latency_sec": round(latency_s, 4),
        "timing": f"cuda events over {k} queued requests",
        "compile_sec": 0.0,  # eager: nothing is compiled
        "request_compile_sec": round(warm_s, 1),  # the two warm-up requests
        "params": "checkpoint" if cfg.ckpt else "fresh-init (identical compute)",
        "bf16": cfg.bf16,
        "device": torch.cuda.get_device_name(device),
        "n_devices": 1,
    }
    print(json.dumps(result))
    return result


def main(argv=None, cfg: Config | None = None, device="cuda"):
    """Samples (``[n, C*H*W]`` NumPy, in the model's value range) or, with
    ``--serve_iters``, the serving measurement."""
    cfg = cfg or parse_config(Config, argv)
    _check_supported(cfg)
    device = require_device(device)
    if cfg.serve_iters > 0:
        return _serve_bench(cfg, _sampler(cfg, _gen_params(cfg, device), device), device)
    if not cfg.ckpt:
        raise SystemExit("--ckpt required")
    call = _sampler(cfg, _gen_params(cfg, device), device)
    outs = [call(min(cfg.batch, cfg.n - i), cfg.seed * 1_000_003 + i).float().cpu()
            for i in range(0, cfg.n, cfg.batch)]
    samples = torch.cat(outs)[: cfg.n].numpy()
    grid_path = f"{cfg.out_prefix}.png"
    save_sample_grid(samples[: min(cfg.n, 100)], _SHAPES[cfg.model], grid_path, value_range=_value_range(cfg))
    print(f"wrote {grid_path} ({min(cfg.n, 100)} samples)")
    if cfg.save_npz:
        np.savez(f"{cfg.out_prefix}.npz", samples=samples)
        print(f"wrote {cfg.out_prefix}.npz {samples.shape}")
    return samples


if __name__ == "__main__":
    main()
