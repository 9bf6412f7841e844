"""Where the 64 px or the 128 px LSUN step's time goes on the card.

    python -m ctgan_tpu_torch.apps.profile_64x64 [lsun128] [--fp32] [trace.json]

Runs an app's configuration at its defaults: without ``lsun128``, the 64
px app (``ct_gan_64x64.Config``: the "Good" ResNet at dim 64, batch 64, 5
critic iterations, wgan-ct, bf16); with it, the LSUN app
(``wgan_lsun128.Config``: ``models.lsun128`` at its full widths, batch 64,
5 critic iterations, wgan-CT, bf16); fp32 with ``--fp32``.  The app's own
step (the pool batch, scaling and flips, one iteration) runs for
``WARMUP`` iterations, then ``ITERS`` iterations are traced with
``torch.profiler``, in two arms (eager, then captured in a CUDA graph as
the app runs it: ``profile_flagship.measure_arms``), and it prints for each
what ``profile_flagship.measure`` measures: s/iter unprofiled, per traced
iteration the wall time, the device busy time and idle share, the device
operations and the busy time by kernel family, with the peak device memory;
then the largest kernels.  The bf16 128 px step's cuDNN kernels overlap, so
its idle share is undefined: read its s/iter.  With a path it also writes
each arm's Chrome trace there.  Needs a CUDA device.
"""

from __future__ import annotations

import sys

import torch

from . import ct_gan_64x64, wgan_lsun128
from .common import gan_batches
from .profile_flagship import measure_arms

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
    run = app.setup(app.Config(BF16=bf16), device)
    measure_arms(app.make_step_fn(run), run.rand, run.state, gan_batches(run), model, argv[0] if argv else None,
                 model=model, bf16=bf16)
    return 0


if __name__ == "__main__":
    sys.exit(main())
