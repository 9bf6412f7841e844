"""Where the 64 px or the 128 px LSUN step's time goes on the card.

    python -m ctgan_tpu_torch.apps.profile_64x64 [lsun128] [--fp32] [trace.json]

Runs an app's configuration at its defaults: without ``lsun128``, the 64
px app (``ct_gan_64x64.Config``: the "Good" ResNet at dim 64, batch 64, 5
critic iterations, wgan-ct, bf16); with it, the LSUN app
(``wgan_lsun128.Config``: ``models.lsun128`` at its full widths, batch 64,
5 critic iterations, wgan-CT, bf16); fp32 with ``--fp32``.  The app's own
step (the pool batch, scaling and flips, one iteration) runs for
``WARMUP`` iterations, then ``ITERS`` iterations are traced with
``torch.profiler``, and it prints what ``profile_flagship.measure``
measures: per iteration the wall time, the device busy time and idle
share, the device operations and the busy time by kernel family, with the
peak device memory of the traced iterations; then the largest kernels.
With a path it also writes the Chrome trace there.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys

import torch

from . import ct_gan_64x64, wgan_lsun128
from .profile_flagship import ITERS, WARMUP, measure, print_top

APPS = {"64x64": ct_gan_64x64, "lsun128": wgan_lsun128}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    bf16 = "--fp32" not in argv
    argv = [a for a in argv if a != "--fp32"]
    model = argv.pop(0) if argv and argv[0] in APPS else "64x64"
    if not torch.cuda.is_available():
        print("profile_64x64: no CUDA device", file=sys.stderr)
        return 1
    app, device = APPS[model], torch.device("cuda")
    run = app.setup(app.Config(ITERS=WARMUP + ITERS, BF16=bf16), device)
    step_fn = app.make_step_fn(run)
    torch.cuda.reset_peak_memory_stats(device)
    summary, by_name = measure(lambda it: step_fn(run.state, run.rand), WARMUP, ITERS,
                               argv[0] if argv else None)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    print(json.dumps({**summary, "model": model, "bf16": bf16, "peak_gib": round(peak, 3)}))
    print_top(by_name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
