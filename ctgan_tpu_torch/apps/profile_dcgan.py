"""Where the MNIST or CIFAR-10 conv GAN's step time goes on the card.

    python -m ctgan_tpu_torch.apps.profile_dcgan mnist|cifar [--fp32] [trace.json]

Runs the app's configuration (``ct_gan_mnist.Config`` or
``ct_gan_cifar.Config`` defaults: wgan-CT, 5 critic iterations, bf16; MNIST
dim 64 and batch 50, CIFAR-10 dim 128 and batch 64; fp32 with ``--fp32``)
through the app's own step (the sampler's batch, one iteration) for
``WARMUP`` iterations, then traces ``ITERS`` iterations with
``torch.profiler``, in two arms (eager, then captured in a CUDA graph as
the app runs it: ``profile_flagship.measure_arms``), and prints for each
what ``profile_flagship.measure`` measures: s/iter unprofiled, per traced
iteration the wall time, the device busy time and idle share, the device
operations and the busy time by kernel family, the peak device memory,
then the largest kernels.  With a path it also writes each arm's Chrome
trace there.  Needs a CUDA device.
"""

from __future__ import annotations

import sys

import torch

from . import ct_gan_cifar, ct_gan_mnist
from .common import gan_batches
from .profile_flagship import measure_arms


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    bf16 = "--fp32" not in argv
    argv = [a for a in argv if a != "--fp32"]
    if not argv or argv[0] not in ("mnist", "cifar"):
        print("usage: profile_dcgan mnist|cifar [--fp32] [trace.json]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profile_dcgan: no CUDA device", file=sys.stderr)
        return 1
    model, argv = argv[0], argv[1:]
    app = ct_gan_mnist if model == "mnist" else ct_gan_cifar
    run = app.setup(app.Config(BF16=bf16), torch.device("cuda"))
    step_fn = ct_gan_mnist.make_step_fn(run, None if model == "mnist" else ct_gan_cifar.to_real)
    measure_arms(step_fn, run.rand, run.state, gan_batches(run), model, argv[0] if argv else None, model=model,
                 bf16=bf16)
    return 0


if __name__ == "__main__":
    sys.exit(main())
