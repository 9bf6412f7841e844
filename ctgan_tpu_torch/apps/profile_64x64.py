"""Where the 64 px step's time goes on the card.

    python -m ctgan_tpu_torch.apps.profile_64x64 [--fp32] [trace.json]

Runs the 64 px app's configuration (``ct_gan_64x64.Config`` defaults: the
"Good" ResNet at dim 64, batch 64, 5 critic iterations, wgan-ct, bf16;
fp32 with ``--fp32``) through the app's own step (the pool batch, scaling
and flips, one iteration) for ``WARMUP`` iterations, then traces ``ITERS``
iterations with ``torch.profiler`` and prints what
``profile_flagship.measure`` measures: per iteration the wall time, the
device busy time and idle share, the device operations and the busy time
by kernel family, then the largest kernels.  With a path it also writes
the Chrome trace there.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys

import torch

from .ct_gan_64x64 import Config, make_step_fn, setup
from .profile_flagship import ITERS, WARMUP, measure, print_top


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    bf16 = "--fp32" not in argv
    argv = [a for a in argv if a != "--fp32"]
    if not torch.cuda.is_available():
        print("profile_64x64: no CUDA device", file=sys.stderr)
        return 1
    run = setup(Config(ITERS=WARMUP + ITERS, BF16=bf16), torch.device("cuda"))
    step_fn = make_step_fn(run)
    summary, by_name = measure(lambda it: step_fn(run.state, run.rand), WARMUP, ITERS,
                               argv[0] if argv else None)
    print(json.dumps({**summary, "bf16": bf16}))
    print_top(by_name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
