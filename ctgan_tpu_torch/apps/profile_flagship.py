"""Where the flagship step's time goes on the card.

    python -m ctgan_tpu_torch.apps.profile_flagship [--fp32] [trace.json]

Runs the flagship app's configuration (``ct_gan_cifar_resnet.Config``
defaults: dim 128, batch 64, 5 critic iterations, bf16; fp32 with
``--fp32``) for ``WARMUP``
iterations, then traces ``ITERS`` iterations with ``torch.profiler``.  It
prints, per iteration: the wall time (host clock, synchronised), the device
busy time (the sum of kernel and copy durations on the one stream) and the
idle share, the number of device operations, and the busy time by kernel
family and by kernel, largest first; then, unprofiled, the host's
milliseconds per iteration of drawing the dequantisation noise on the CPU
and copying it from pinned memory, the route the port does not take
(``philox_uniform`` draws it on the card).  With a path it also writes the
Chrome trace there.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from typing import Callable

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .ct_gan_cifar_resnet import Config, setup

WARMUP = 5
ITERS = 3
TOP = 15

# kernel-name substrings, checked in order; the first match names the family
FAMILIES = [
    ("dropout_mask", ("dropout_mask_kernel",)),
    ("philox_uniform", ("philox_uniform_kernel",)),
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw")),
    ("layer norm", ("layer_norm",)),
    ("conv (cuDNN)", ("conv", "xmma", "implicit", "cudnn", "winograd", "fft", "dgrad", "wgrad",
                      "fprop", "sm90", "cutlass")),
    ("gemm", ("gemm", "gemv")),
    ("reduction", ("reduce",)),
    ("copy", ("memcpy", "memset", "copy")),
    ("pool/upsample", ("pool", "upsample")),
    ("elementwise", ("elementwise", "vectorized", "foreach")),
]


def family(name: str) -> str:
    lower = name.lower()
    for fam, keys in FAMILIES:
        if any(k in lower for k in keys):
            return fam
    return "other"


def host_dequant_ms(cfg: Config, device, reps: int = 20) -> float:
    """Host ms per iteration of the dequantisation noise drawn on the CPU
    (one ``[BATCH_SIZE, 3072]`` draw per critic substep) and copied."""
    gen = torch.Generator()
    gen.manual_seed(cfg.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for _ in range(cfg.N_CRITIC):
            u = torch.rand(cfg.BATCH_SIZE, 3072, generator=gen).mul_(1 / 128)
            u.pin_memory().to(device, non_blocking=True)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def measure(step: Callable[[int], object], warmup: int, iters: int,
            trace_path: str | None = None) -> tuple[dict, dict]:
    """``step(it)`` for ``warmup`` iterations, then ``iters`` more traced:
    per iteration the wall time (synchronised), the device busy time (the
    sum of kernel and copy durations on the one stream) and the idle share,
    the number of device operations and the busy time by kernel family.
    Returns that summary (ms per iteration) and the busy microseconds per
    iteration by kernel name.  With ``trace_path`` it also writes the Chrome
    trace there."""
    for it in range(warmup):
        step(it)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it in range(warmup, warmup + iters):
            step(it)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if trace_path:
        prof.export_chrome_trace(trace_path)
    by_name, by_family = defaultdict(float), defaultdict(float)
    n_ops = 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        dur = evt.time_range.elapsed_us()
        by_name[evt.name] += dur
        by_family[family(evt.name)] += dur
        n_ops += 1
    busy_us = sum(by_name.values())
    per_it = lambda us: round(us / iters / 1e3, 5)  # ms per iteration
    summary = {
        "device": torch.cuda.get_device_name(0),
        "iters": iters,
        "wall_ms_per_iter": per_it(wall_us),
        "device_busy_ms_per_iter": per_it(busy_us),
        "device_idle_share": round(1 - busy_us / wall_us, 5) if busy_us else None,
        "device_ops_per_iter": n_ops / iters,
        "families_ms_per_iter": {k: per_it(v) for k, v in sorted(by_family.items(), key=lambda kv: -kv[1])},
    }
    return summary, {name: us / iters for name, us in by_name.items()}


def print_top(by_name: dict) -> None:
    """The ``TOP`` kernels by busy time per iteration."""
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"{us / 1e3:10.5f} ms/iter  {name[:140]}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    bf16 = "--fp32" not in argv
    argv = [a for a in argv if a != "--fp32"]
    if not torch.cuda.is_available():
        print("profile_flagship: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    cfg = Config(ITERS=WARMUP + ITERS, BF16=bf16)
    trainer, state, sampler, rand, _ = setup(cfg, device)

    def step(it):
        trainer.step(state, *sampler.sample(it), rand.for_step(it))

    summary, by_name = measure(step, WARMUP, ITERS, argv[0] if argv else None)
    print(json.dumps({**summary, "bf16": bf16,
                      "host_dequant_ms_per_iter": round(host_dequant_ms(cfg, device), 5)}))
    print_top(by_name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
