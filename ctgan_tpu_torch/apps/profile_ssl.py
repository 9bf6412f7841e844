"""Where a semi-supervised step's time goes on the card.

    python -m ctgan_tpu_torch.apps.profile_ssl mnist|cifar|te [trace.json]

Builds the app's run at its ``Config`` defaults (``ct_mnist_ssl``, or
``ct_cifar_ssl`` without and with ``temporal_ensembling``; fp32, batch 100,
the data-dependent init included) and runs the app's own step on the
batches of epoch 0's order in two arms (eager, then captured in a CUDA
graph as the app runs it: ``profile_flagship.measure_arms``): ``WARMUP``
steps, ``TIMED`` unprofiled, then ``ITERS`` traced with
``torch.profiler``, and prints for each what ``profile_flagship.measure``
measures: s/step unprofiled, per traced step the wall time
(synchronised), the device busy time and idle share, the device operations,
the busy time by kernel family, the peak device memory, then the largest
kernels.  For MNIST it also times, unprofiled, the host's draw of one
step's Gaussian noise (36 draws, 1.82 M normals) and its pinned copies.
With a path it writes each arm's Chrome trace there.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from ..core import Randomness
from . import ct_cifar_ssl, ct_mnist_ssl, ssl_common
from .profile_flagship import measure_arms

MODELS = ("mnist", "cifar", "te")


def host_noise_ms(app: ssl_common.SslApp, batch: int, reps: int = 10) -> tuple[float, int]:
    """Host ms per MNIST step of its Gaussian noise (every pass's six
    draws, as the step asks for them) drawn on the CPU and copied to the
    card, and the normals drawn per step."""
    widths = (784, 1000, 500, 250, 250, 250)
    passes = 6  # 4 of D's loss, 2 of G's
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(reps):
        rand = Randomness(app.rand.seed, app.rand.device).for_step(step)
        for _ in range(passes):
            for w in widths:
                rand.normal((batch, w))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, passes * batch * sum(widths)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in MODELS:
        print("usage: profile_ssl mnist|cifar|te [trace.json]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profile_ssl: no CUDA device", file=sys.stderr)
        return 1
    model, argv = argv[0], argv[1:]
    device = torch.device("cuda")
    if model == "mnist":
        cfg = ct_mnist_ssl.Config()
        app = ct_mnist_ssl.setup(cfg, device)
    else:
        cfg = ct_cifar_ssl.Config(temporal_ensembling=model == "te")
        app = ct_cifar_ssl.setup(cfg, device)
    bs = cfg.batch_size
    orders = [torch.from_numpy(o).to(device)
              for o in ssl_common.epoch_orders(cfg.seed, 0, len(app.train), len(app.labeled[0]))]
    n_classes = 10
    targets = None
    if model == "te":
        targets = (torch.full((bs, n_classes), 1 / n_classes, device=device),
                   torch.zeros(bs, ssl_common.TE_FEATURES, device=device))
    inputs = lambda it: (*(o[it * bs:(it + 1) * bs] for o in orders), targets)
    measure_arms(ssl_common.make_step_fn(app), app.rand, app.state, inputs, model, argv[0] if argv else None,
                 model=model)
    if model == "mnist":
        ms, normals = host_noise_ms(app, bs)
        print(json.dumps({"host_noise_ms_per_step": round(ms, 5), "normals_per_step": normals}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
