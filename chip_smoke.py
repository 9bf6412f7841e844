#!/usr/bin/env python3
"""Smoke run of ``ctgan_tpu_torch`` on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its seconds:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` builds every CUDA kernel (ptxas report on stderr);
3. kernel: the dropout-mask kernel against its plain PyTorch version at the
   flagship's three mask shapes, fp32 and bf16, keep prob 0.8 and 0.5: bit
   for bit, keep fraction, determinism; then its time beside its byte bound,
   the plain version's time and ``bernoulli_``'s;
4. cuda_vs_cpu: two flagship iterations at dim 16 on the card and on the
   CPU with the same draws (masks from the kernel on the card, from the
   plain version on the CPU), TF32 off, params compared;
5. train: the flagship app (``apps.ct_gan_cifar_resnet.main``) at full
   width and defaults for 10 iterations on synthetic CIFAR-10, with the
   kernel's launches counted, seconds per iteration and peak memory.

The last lines are the kernel record and ``{"ok": true, "device": ...}``.
Any failure raises and the script exits non-zero; without a CUDA device it
stops before printing any result.  It writes only under ``build/`` and a
temporary directory.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ctgan_tpu_torch.apps import ct_gan_cifar_resnet as app
from ctgan_tpu_torch.bridge import from_jax_params
from ctgan_tpu_torch.core import Randomness, split_params
from ctgan_tpu_torch.kernels import SOURCES, dropout_mask, dropout_mask_reference
from ctgan_tpu_torch.kernels.build import build_libraries
from ctgan_tpu_torch.models import resnet_cifar
from ctgan_tpu_torch.train import AcganConfig, AcganTrainer
from ctgan_tpu_torch.train.optim import adam_mismatches

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
TRAIN_ITERS = 10


def _phase(name, fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)
    return out


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    for stem, report in build_libraries(SOURCES).items():
        print(f"--- nvcc {stem}\n{report}", file=sys.stderr, flush=True)


def flagship_mask_shapes(dim: int = 128, batch: int = 64, gen_bs_multiple: int = 2):
    """NCHW shapes of the flagship's masks: G substep, fused CT pair, GP."""
    return [(gen_bs_multiple * batch, dim, 8, 8), (4 * batch, dim, 8, 8), (batch, dim, 8, 8)]


def _time_ms(fn, n: int) -> float:
    """Device time per call: the calls queue behind a sleeping kernel, so
    the events measure the device's work, not the host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def phase_kernel(device) -> dict:
    max_err = 0.0
    seed = 12345
    for shape in flagship_mask_shapes():
        n = math.prod(shape)
        for dtype in (torch.float32, torch.bfloat16):
            for kp in (0.8, 0.5):
                got = dropout_mask(seed, shape, kp, dtype, device)
                torch.cuda.synchronize()
                want = dropout_mask_reference(seed, shape, kp, dtype, device)
                err = float((got.float() - want.float()).abs().max())
                max_err = max(max_err, err)
                if not torch.equal(got, want):
                    raise AssertionError(f"kernel != plain version at {shape} {dtype} kp {kp}: {err}")
                frac = float((got != 0).float().mean())
                if abs(frac - kp) > 5 * math.sqrt(kp * (1 - kp) / n):
                    raise AssertionError(f"keep fraction {frac} at kp {kp}")
                again = dropout_mask(seed, shape, kp, dtype, device)
                other = dropout_mask(seed + 1, shape, kp, dtype, device)
                torch.cuda.synchronize()
                if not torch.equal(again, got) or torch.equal(other, got):
                    raise AssertionError("mask not determined by its seed")
    tail = dropout_mask(7, (1001,), 0.5, torch.bfloat16, device)  # ragged tail
    if not torch.equal(tail, dropout_mask_reference(7, (1001,), 0.5, torch.bfloat16, device)):
        raise AssertionError("kernel != plain version on a ragged tail")

    times = {}
    for shape in flagship_mask_shapes():
        for dtype in (torch.float32, torch.bfloat16):
            times[f"{list(shape)} {str(dtype)[6:]}"] = _time_ms(
                lambda: dropout_mask(seed, shape, 0.5, dtype, device), 200)
    print("kernel_ms " + json.dumps(times))
    shape = flagship_mask_shapes()[1]  # the largest: the fused CT pair
    n = math.prod(shape)
    ms = times[f"{list(shape)} float32"]
    plain_ms = _time_ms(lambda: dropout_mask_reference(seed, shape, 0.5, torch.float32, device), 10)
    library_ms = _time_ms(lambda: torch.empty(shape, device=device).bernoulli_(0.5), 200)
    bound_ms = n * 4 / HBM_BYTES_PER_S * 1e3
    print(f"dropout_mask {list(shape)} fp32: {ms:.5f} ms (byte bound {bound_ms:.5f} ms), "
          f"plain {plain_ms:.5f} ms, bernoulli_ {library_ms:.5f} ms")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, library_ms=library_ms)


def _small_run(device, params, *, dim, batch, n_critic, iters, seed):
    mcfg = resnet_cifar.ResnetCifarConfig(dim_g=dim, dim_d=dim)
    trainer = AcganTrainer(
        lambda p, n, labels, rand, noise=None: resnet_cifar.generator(p, n, labels, mcfg, rand, noise=noise),
        lambda p, x, labels, kps, rand: resnet_cifar.discriminator(p, x, labels, kps, mcfg, rand),
        AcganConfig(batch_size=batch, critic_iters=n_critic, iters=100),
    )
    tensors = {k: v.to(device) for k, v in from_jax_params(params).items()}
    gen, disc, _ = split_params(tensors, "Generator", "Discriminator")
    state = trainer.init_state(gen, disc)
    data = np.random.default_rng(seed)
    rand = Randomness(seed, device, generator_device="cpu")
    metrics = []
    for _ in range(iters):
        real = torch.from_numpy(data.integers(0, 256, (n_critic, batch, 3072), dtype=np.uint8))
        labels = torch.from_numpy(data.integers(0, 10, (n_critic, batch)))
        m = trainer.step(state, real.to(device), labels.to(device), rand)
        metrics.append({k: float(v) for k, v in m.items()})
    params = {k: v.detach().cpu().numpy() for k, v in {**state.gen_params, **state.disc_params}.items()}
    return params, metrics, trainer.cfg.lr


def phase_cuda_vs_cpu(device, *, dim=16, batch=4, n_critic=2, iters=2, seed=0) -> float:
    """``iters`` iterations from the same fresh params and draws on
    ``device`` and on the CPU, with TF32 off.  Metrics to rtol 1e-3; params
    by ``adam_mismatches`` (atol 1e-6, 2 * lr allowance for Adam steps on
    gradients that are zero up to rounding).  Returns the largest param
    difference."""
    params = resnet_cifar.init_params(resnet_cifar.ResnetCifarConfig(dim_g=dim, dim_d=dim), seed)
    old = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        got, got_m, lr = _small_run(device, params, dim=dim, batch=batch, n_critic=n_critic,
                                    iters=iters, seed=seed)
    finally:
        torch.backends.cudnn.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])
    want, want_m, _ = _small_run("cpu", params, dim=dim, batch=batch, n_critic=n_critic,
                                 iters=iters, seed=seed)
    for g, w in zip(got_m, want_m):
        for k in w:
            if not math.isclose(g[k], w[k], rel_tol=1e-3, abs_tol=1e-5):
                raise AssertionError(f"metric {k}: {g[k]} on {device} vs {w[k]} on cpu")
    zero_grad = resnet_cifar.zero_grad_params(resnet_cifar.ResnetCifarConfig(dim_g=dim, dim_d=dim))
    bad = adam_mismatches(got, want, lr=lr, n_updates=iters * n_critic, zero_grad=zero_grad)
    if bad:
        raise AssertionError(f"params on {device} vs cpu: {bad}")
    diff = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    print(f"{device} vs cpu after {iters} iterations: max param diff {diff:.3g}")
    return diff


def phase_train(device, cfg: app.Config) -> dict:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    dropout_mask.launches = 0
    state, records = app.main(cfg=cfg, device=device)
    launches = dropout_mask.launches
    # per iteration: G substep 3 masks; each critic substep 3 (CT pair) + 3 (GP);
    # the kp=1 clean pass makes none
    expected = cfg.ITERS * (3 + 6 * cfg.N_CRITIC) if device.type == "cuda" else 0
    if launches != expected:
        raise AssertionError(f"dropout_mask launched {launches} times, expected {expected}")
    last = records[-1]
    for k in ("wgan", "ct", "gp", "acgan", "gen_cost"):
        if not math.isfinite(last[k]):
            raise AssertionError(f"{k} = {last[k]}")
    mcfg = resnet_cifar.ResnetCifarConfig(dim_g=cfg.DIM_G, dim_d=cfg.DIM_D)
    with torch.no_grad():
        labels = torch.arange(100, device=device) % 10
        samples = resnet_cifar.generator(state.gen_params, 100, labels, mcfg, Randomness(1, device))
    if samples.shape != (100, 3072) or not bool(torch.isfinite(samples).all()) or samples.abs().max() > 1:
        raise AssertionError("generator samples are not finite [100, 3072] values in [-1, 1]")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return dict(launches=launches, s_per_iter=last["time"], peak_bytes=peak, last=last)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    t0 = time.perf_counter()
    smi = _phase("device", phase_device)
    _phase("build", phase_build)
    kernel = _phase("kernel", phase_kernel, device)
    _phase("cuda_vs_cpu", phase_cuda_vs_cpu, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        cfg = app.Config(ITERS=TRAIN_ITERS, out_dir=out_dir)
        train = _phase("train", phase_train, device, cfg)
    print(f"train: {json.dumps(dataclasses.asdict(cfg) | {'out_dir': '<tmp>'})}")
    print(f"train: {train['s_per_iter']:.5f} s/iter over iterations 5-{TRAIN_ITERS - 1}, "
          f"peak {train['peak_bytes'] / 2**30:.3f} GiB, launches {train['launches']}, "
          f"last {json.dumps(train['last'])}")
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(f"card: {smi}")
    print(json.dumps({"kernels": [{
        "name": "dropout_mask", "route": "cuda", "source": "ctgan_tpu_torch/csrc/dropout_mask.cu",
        "replaces": "ctgan_tpu/kernels/dropout.py:35", "launches": train["launches"],
        **kernel, "bound_by": "bytes",
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
