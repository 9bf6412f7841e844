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

Ahead-of-time serving (``utils/aot.py``): ``--aot_save art.pt2`` exports
G's forward at ``--batch`` with ``torch.export`` and writes it as a
weight-independent artifact (its inputs are G's params, the noise and, for
``cifar_resnet``, the labels); ``--aot art.pt2`` loads it in another
process, with no model Python and no tracing, and serves any checkpoint of
that model, every request at the artifact's batch (a ragged tail padded,
then sliced), its draws made as the eager path makes them, so the samples
of a full batch are the eager samples.  An artifact for another model,
width, batch or precision is refused.

    python -m ctgan_tpu_torch.apps.generate --batch 1024 --aot_save flagship_b1024.pt2
    python -m ctgan_tpu_torch.apps.generate --ckpt ... --batch 1024 --aot flagship_b1024.pt2 --serve_iters 50

Several processes (``torchrun``, one per GPU; ``common.maybe_mesh``), as the
JAX app shards each request's batch over its mesh
(``ctgan_tpu/apps/generate.py:136-155``): G's weights are replicated, each
rank makes its rows of every request of ``--batch`` (its rows of the
one-process draws, G's batch norms over the whole request), the samples are
gathered on rank 0, which alone writes them, and ``--serve_iters``'
images/s is the sum over the ranks.  ``--aot``/``--aot_save`` are
single-device and refused there.

    torchrun --nproc_per_node 2 -m ctgan_tpu_torch generate --batch 1024 --serve_iters 20
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
from ..ops.norm import batch_group
from ..parallel.collectives import all_gather_cat
from ..utils.aot import load_aot, save_aot
from ..utils.checkpoint import load_checkpoint
from .common import is_main, maybe_mesh, parse_config, require_device, save_sample_grid

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
    aot_save: str = ""  # export G at --batch and write the artifact here
    aot: str = ""  # serve from this artifact
    aot_strict: bool = True  # refuse an artifact of another torch version or device (utils/aot.py)


LSUN128 = lsun128.Lsun128Config()  # the JAX app serves the default widths

_SHAPES = {"cifar_resnet": (3, 32, 32), "good64": (3, 64, 64), "mnist": (1, 28, 28), "cifar": (3, 32, 32),
           "lsun128": (3, 128, 128)}


def _check_supported(cfg: Config) -> None:
    if cfg.model not in _SHAPES:
        raise ValueError(f"unknown model {cfg.model!r}")


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


def _forward(cfg: Config):
    """``forward(params, noise, labels=None) -> [n, C*H*W]`` images (bf16
    under ``--bf16``): G on its draws, the function ``--aot_save`` exports."""
    mcfg = resnet_cifar.ResnetCifarConfig(dim_g=cfg.dim, dim_d=cfg.dim)

    def forward(params: dict, noise: torch.Tensor, labels: torch.Tensor | None = None) -> torch.Tensor:
        n = noise.shape[0]
        with precision_policy("bfloat16" if cfg.bf16 else "float32"):
            if cfg.model == "good64":
                return good64.generator(params, n, None, dim=_width_64(cfg), noise=noise)
            if cfg.model == "mnist":
                return dcgan.mnist_generator(params, n, None, dim=_width_64(cfg), noise=noise)
            if cfg.model == "cifar":
                return dcgan.cifar_generator(params, n, None, dim=cfg.dim, noise=noise)
            if cfg.model == "lsun128":
                return lsun128.generator(params, n, None, cfg=LSUN128, noise=noise)
            return resnet_cifar.generator(params, n, labels, mcfg, None, noise=noise)

    return forward


def _draws(cfg: Config, n: int, seed: int, device, mesh=None) -> tuple[torch.Tensor, ...]:
    """A request's draws from ``seed``: ``(noise,)``, or for
    ``cifar_resnet`` ``(noise, labels)``, the labels drawn first.  Over a
    ``mesh``, this rank's ``n`` rows of the draws of ``n * world``."""
    rand = Randomness(seed, device) if mesh is None else Randomness(seed, device, rank=mesh.rank, world=mesh.world)
    if cfg.model == "cifar_resnet":
        labels = rand.labels(n, resnet_cifar.ResnetCifarConfig().n_labels)
        return rand.noise(n, resnet_cifar.NOISE_DIM), labels
    return (rand.noise(n, resnet_cifar.NOISE_DIM),)


def _sampler(cfg: Config, params: dict, device, mesh=None):
    """``call(n, seed) -> [n, C*H*W]`` images (bf16 under ``--bf16``),
    noise (and labels) drawn from ``seed``.  Over a ``mesh``: this rank's
    ``n / world`` rows of the request of ``n``, G's batch norms over the
    mesh."""
    forward = _forward(cfg)

    @torch.no_grad()
    def call(n: int, seed: int) -> torch.Tensor:
        if mesh is None:
            return forward(params, *_draws(cfg, n, seed, device))
        if n % mesh.world:
            raise SystemExit(f"a request of {n} does not split over the {mesh.world} processes")
        with batch_group(mesh.world_group):
            return forward(params, *_draws(cfg, n // mesh.world, seed, device, mesh))

    return call


class _Program(torch.nn.Module):
    """G's forward as the module ``torch.export`` takes."""

    def __init__(self, forward):
        super().__init__()
        self.fn = forward

    def forward(self, params: dict, noise: torch.Tensor, labels: torch.Tensor | None = None) -> torch.Tensor:
        return self.fn(params, noise, labels)


def _aot_save(cfg: Config, params: dict, device) -> dict:
    """Export G at ``--batch`` and write the artifact; ``compile_sec`` is
    the export's seconds."""
    t0 = time.perf_counter()
    program = torch.export.export(_Program(_forward(cfg)), (params, *_draws(cfg, cfg.batch, cfg.seed, device)))
    compile_s = time.perf_counter() - t0
    meta = save_aot(cfg.aot_save, program, device,
                    meta={"model": cfg.model, "batch": cfg.batch, "bf16": cfg.bf16, "dim": cfg.dim})
    result = {"aot_path": cfg.aot_save, "compile_sec": round(compile_s, 1), **meta}
    print(json.dumps(result))
    return result


def _aot_sampler(cfg: Config, params: dict, device):
    """``(call(seed) -> [batch, C*H*W], meta)`` from the artifact
    ``--aot``; an artifact for another model, width, batch or precision
    than ``cfg`` asks for is refused."""
    program, meta = load_aot(cfg.aot, strict=cfg.aot_strict, device=device)
    wrong = [f"{k} {meta.get(k)!r} (asked for {getattr(cfg, k)!r})"
             for k in ("model", "dim", "batch", "bf16") if meta.get(k) != getattr(cfg, k)]
    if wrong:
        raise SystemExit(f"--aot {cfg.aot} was exported for another configuration: " + ", ".join(wrong)
                         + "; export one with --aot_save for this one")

    @torch.no_grad()
    def call(seed: int) -> torch.Tensor:
        return program(params, *_draws(cfg, cfg.batch, seed, device))

    return call, meta


def _serve_bench(cfg: Config, request, device, *, aot_meta: dict | None = None, mesh=None) -> dict:
    """``serve_iters`` requests of ``batch`` images (``request(seed)``)
    queued back to back and timed with CUDA events (device time per batch),
    after two warm-up requests; then one request timed on the host clock,
    synchronised.  ``aot_meta``: the requests run a loaded artifact.  Over
    a ``mesh`` each rank times its rows of every request; ``value`` is the
    sum of the ranks' images/s, printed by rank 0."""
    if device.type != "cuda":
        raise RuntimeError("--serve_iters measures the card: it needs a CUDA device")
    k = max(cfg.serve_iters, 10)
    t_c = time.perf_counter()
    for i in range(2):
        request(cfg.seed + i)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_c
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(k):
        request(cfg.seed + 10 + i)
    end.record()
    end.synchronize()
    sec_per_batch = start.elapsed_time(end) / 1e3 / k
    t0 = time.perf_counter()
    request(cfg.seed + 7)
    torch.cuda.synchronize()
    latency_s = time.perf_counter() - t0
    world = 1 if mesh is None else mesh.world
    images_per_s = torch.tensor([cfg.batch / world / sec_per_batch], dtype=torch.float64, device=device)
    if mesh is not None:
        torch.distributed.all_reduce(images_per_s, group=mesh.world_group)
    result = {
        "metric": f"{cfg.model}_gen_samples_per_sec_per_chip",
        "value": round(float(images_per_s), 2),
        "unit": "images/sec/chip",
        "vs_baseline": None,
        "batch": cfg.batch,
        "sec_per_batch": round(sec_per_batch, 6),
        "request_latency_sec": round(latency_s, 4),
        "timing": f"cuda events over {k} queued requests" + (", aot program" if aot_meta else ""),
        "compile_sec": 0.0,  # nothing is compiled in this process
        # the artifact's load, or the two eager warm-up requests
        "request_compile_sec": aot_meta["load_sec"] if aot_meta else round(warm_s, 1),
        **({"aot": cfg.aot} if aot_meta else {}),
        "params": "checkpoint" if cfg.ckpt else "fresh-init (identical compute)",
        "bf16": cfg.bf16,
        "device": torch.cuda.get_device_name(device),
        "n_devices": world,
    }
    if is_main(mesh):
        print(json.dumps(result))
    return result


def main(argv=None, cfg: Config | None = None, device="cuda"):
    """Samples (``[n, C*H*W]`` NumPy, in the model's value range) or, with
    ``--serve_iters``, the serving measurement, or with ``--aot_save`` the
    export's record."""
    cfg = cfg or parse_config(Config, argv)
    _check_supported(cfg)
    device = require_device(device)
    mesh = maybe_mesh(device=device)
    if mesh is not None:
        device = mesh.device
        if cfg.aot or cfg.aot_save:
            raise SystemExit("AOT serving artifacts are single-device; multi-chip "
                             "serving runs G eagerly, each process its rows of every request")
        if cfg.batch % mesh.world:
            raise SystemExit(f"--batch {cfg.batch} must divide over the {mesh.world} processes")
    if cfg.aot_save:
        return _aot_save(cfg, _gen_params(cfg, device), device)
    if cfg.serve_iters > 0:
        params = _gen_params(cfg, device)
        if cfg.aot:
            call, meta = _aot_sampler(cfg, params, device)
            return _serve_bench(cfg, call, device, aot_meta=meta)
        eager = _sampler(cfg, params, device, mesh)
        return _serve_bench(cfg, lambda seed: eager(cfg.batch, seed), device, mesh=mesh)
    if not cfg.ckpt:
        raise SystemExit("--ckpt required")
    params = _gen_params(cfg, device)
    seeds = [(i, cfg.seed * 1_000_003 + i) for i in range(0, cfg.n, cfg.batch)]
    if cfg.aot:
        # every request at the artifact's batch; a ragged tail is padded, then sliced
        call, meta = _aot_sampler(cfg, params, device)
        print(f"aot: loaded {cfg.aot} in {meta['load_sec']}s")
        outs = [call(seed)[: cfg.n - i].float().cpu() for i, seed in seeds]
    else:
        eager = _sampler(cfg, params, device, mesh)
        outs = [eager(min(cfg.batch, cfg.n - i), seed).float() for i, seed in seeds]
        if mesh is not None:
            # each rank's rows of every request, in rank order: the one-process request
            outs = [all_gather_cat(out, 0, mesh.world_group, mesh.world) for out in outs]
        outs = [out.cpu() for out in outs]
    samples = torch.cat(outs)[: cfg.n].numpy()
    if not is_main(mesh):
        return samples
    grid_path = f"{cfg.out_prefix}.png"
    save_sample_grid(samples[: min(cfg.n, 100)], _SHAPES[cfg.model], grid_path, value_range=_value_range(cfg))
    print(f"wrote {grid_path} ({min(cfg.n, 100)} samples)")
    if cfg.save_npz:
        np.savez(f"{cfg.out_prefix}.npz", samples=samples)
        print(f"wrote {cfg.out_prefix}.npz {samples.shape}")
    return samples


if __name__ == "__main__":
    main()
