#!/usr/bin/env python3
"""Smoke run of ``ctgan_tpu_torch`` on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its seconds:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` builds every CUDA kernel (ptxas report on stderr; the
   registers of each kernel printed);
3. kernel: the dropout-mask kernel against its plain PyTorch version at the
   flagship's three training mask shapes and its two dev-cost shapes, the
   64 px critic's three shapes, the MNIST and CIFAR-10 conv critics' three
   each and two ragged MNIST counts, fp32
   and bf16, and the semi-supervised CIFAR-10 classifier's three at batch
   100 and at the data-dependent init's 500, fp32 (its dtype), and the
   128 px critic's one in fp32 and bf16,
   keep prob 0.8 and 0.5: bit for bit, keep fraction,
   determinism; a mask read from slot k of a seed table equals the mask of
   the int seed that slot holds; the Philox-uniform kernel against its
   plain version at the dequantisation noise's shapes (a critic batch, the
   dev batch), bit for bit.  Then, at every one of those shapes, each
   kernel's time beside one PyTorch call's (``bernoulli_`` in the same
   dtype, ``uniform_``) and two bounds: the bytes written at 3.35 TB/s
   (the H100 SXM's rate, for NVIDIA H100 80GB HBM3 at 700 W), and the
   operations, from the instructions the build's SASS runs per
   element (``kernels/sass.py``: ``cuobjdump -sass``) at the Programming
   Guide's rates per SM and clock for compute capability 9.0 (integer 64)
   on the card's SMs at its maximum SM clock (``nvidia-smi``); the larger
   is the bound.  The plain versions' time at the record shapes;
4. capture: one iteration's 38 Philox draws (the flagship's 33 bf16 masks
   and 5 dequantisation draws, in the trainer's order) captured in one
   CUDA graph against a static device seed table; for steps 0, 1 and 781
   the step's seeds are copied into the table and the graph replayed, and
   every draw must equal the eager draws of ``Randomness.for_step`` bit for
   bit; then a replay's device and host time against the 38 eager
   launches;
5. draws: the run's draws on the card against the CPU's, bit for bit: the
   sampler's epoch permutations and every draw of ``Randomness.for_step``
   at three steps, at the flagship's shapes (the later steps' masks at
   slices); and the host cost per iteration of the draws the CPU makes;
6. cuda_vs_cpu: two flagship iterations at dim 16 on the card and on the
   CPU with the same draws, in fp32 (TF32 off) and in bf16, substep by
   substep from the same state, losses, gradients and updated params
   compared; in bf16 first G and D on one batch; then cuda_vs_cpu_gan:
   the same for the unconditional trainer and the 64 px "Good" ResNet at
   dim 16, wgan-ct in fp32 and bf16 and wgan-gp (batch norm in D) in fp32;
7. train: the flagship app (``apps.ct_gan_cifar_resnet.main``) at its
   defaults (bf16 on the card) and full width for 10 iterations in a
   temporary ``out_dir``, through the train loop: checkpoints every 5
   iterations, a sample grid and the dev cost every 5, IS and FID at
   iteration 9 over 5,000 generated images (cut from 50,000 for time) with
   a TrainedScorer fitted on the card; the files are checked and the grids
   decoded.  Then ``main`` again with ``ITERS=12`` in the same directory,
   which must resume at iteration 10.  Then the same 10 iterations with
   ``BF16=False`` (fp32), and 4 iterations with ``NORMALIZATION_D=True``.
   Each kernel's launches are counted in each call;
8. resume_equal: at dim 16, with cuDNN deterministic, 4 iterations
   uninterrupted against 2 + checkpoint + a fresh trainer + 2, in fp32 and
   in bf16;
9. jax_checkpoint: the JAX package's dim-128 checkpoint
   ``runs/flagship_fused_r4/ckpt/ckpt_25000.npz`` and its scorer
   ``scorer.npz`` (sha256 printed) loaded into the port; the app's
   ``test_fn`` as the JAX app ran it at iteration 24999 (dev cost, IS over
   50,000 samples in chunks of 5,000, FID on 10,000), in bf16 and in fp32,
   each beside the JAX run's logged value, with ``|IS - 9.70838| <= 0.30``
   as the gate against layout and loading errors, and the dev cost's spread
   over 8 other seeds of its draws; then ``apps.generate`` on the same
   checkpoint: a 100-sample grid, and ``--batch 1024 --serve_iters 20`` in
   fp32 and with ``--bf16``;
10. train64: the 64 px app (``apps.ct_gan_64x64.main``) at its defaults
    (bf16, dim 64, batch 64, 5 critic iterations, wgan-ct) for 10
    iterations of the 4,096-image pool: checkpoints and grids every 5, IS
    and FID on 1,000 images at iteration 9 with a scorer fitted on the
    card; each step timed between two synchronisations, 63 mask launches
    per iteration; then ``main`` to 12, which resumes at 10, and 4
    iterations in fp32;
11. resume_equal_gan: the 64 px step at dim 16, 4 iterations against 2 +
    checkpoint + 2, in fp32 and bf16, max param diff 0;
12. good64_checkpoint: the JAX run's ``runs/good64_r5/params_latest.npz``
    through the bridge, 1,000 images of fixed noise in batches of 100 in
    fp32 and bf16, IS with the committed ``scorer.npz`` gated against the
    JAX package's (``GOOD64_IS_REF``) and, loosely, the run's logged IS;
    fp32 G on the card against the CPU on 100 images; ``apps.generate
    --model good64`` at batch 1024, fp32 and ``--bf16``;
13. cuda_vs_cpu_dcgan (after cuda_vs_cpu_gan): the MNIST conv GAN at full
    width (dim 64, batch 50, wgan-CT) on the card and the CPU, substep by
    substep, fp32 (TF32 off) and bf16, with cuda_vs_cpu_gan's bounds;
14. dcgan_ref (after it): the port's MNIST (dim 64) and CIFAR-10 (dim 128)
    G and D at seed 0 in fp32, TF32 off, against the JAX package's outputs
    pinned in ``DCGAN_REF`` (100 images, logits at keep 1), within 1e-4;
15. train_mnist / train_cifar (after train_norm_d): each app's ``main`` at
    its defaults (bf16, full width) for 10 iterations (test_fn every 5,
    CIFAR-10's IS at iteration 9 on 1,000 through the flagship phase's
    fitted scorer), resumed to 12, and 4 iterations in fp32: files, grids,
    dev costs, ``slope_real``, mask launches per call (63 per iteration,
    120 / 123 per test_fn), s/iter synchronised each step, peak memory;
16. serve_dcgan: ``apps.generate --model mnist|cifar`` on those runs'
    ``params_latest.npz``: a grid, batch 1024 in fp32 and ``--bf16``;
17. cuda_vs_cpu_ssl_mnist|cifar|te (after it): one step of the
    semi-supervised trainer at full width (MNIST batch 20, CIFAR-10 batch
    4, the plain and the temporal-ensembling variant) on the card and the
    CPU from the same state with the same draws, fp32 with TF32 off: the
    losses to rtol 1e-3, each network's gradient within
    ``FP32_GRAD_BOUND`` of the CPU's L1 mass;
18. ssl_ref: the JAX runs' classifiers (``runs/ssl_te_r5/avg_params.npz``,
    CIFAR-10; ``runs/ssl_mnist_full/disc_params.npz``, MNIST, which kept no
    average) loaded into the port: their deterministic logits on the first
    16 synthetic test images, fp32 with TF32 off, against the JAX package's
    pinned in ``SSL_REF`` (within ``SSL_REF_BOUND``, absolute, argmax
    equal); then the test error over the whole synthetic test set
    beside the JAX runs' last logged ``test_err`` (0.0), a loading gate;
19. train_ssl_mnist / train_ssl_cifar / train_ssl_te: each app's ``main`` at
    the JAX defaults (full width, full data, batch 100), cut in depth: MNIST
    one epoch and ``main`` again to two (a resume from ``ssl_state.npz``),
    CIFAR-10 and temporal ensembling one epoch (CIFAR-10's resume cut for
    time, ``run_ssl_apps``); s/step (each step
    synchronised) and s/epoch, test error, peak memory, and the mask
    launches of every step (18 for CIFAR-10, 15 with temporal ensembling, 0
    for MNIST) and of the run (3 more at the data-dependent init);
20. resume_equal_ssl: MNIST two epochs straight against train_ssl_mnist's
    one + resume, every array of the state equal (max diff 0);
21. lsun128_ref (after ssl_ref): the port's full-width 128 px LSUN G
    (``models.lsun128``, seed 0) on 16 images of ``default_rng(0)`` noise
    and its D at keep 1 on them, fp32 with TF32 off, against the JAX
    package's outputs pinned in ``LSUN128_REF``, within 1e-4;
22. cuda_vs_cpu_lsun128 (after it): the LSUN app's trainer on the 128 px
    model at ``LSUN128_SMALL``'s widths, batch 4, card against CPU substep
    by substep in fp32 and bf16 (the losses in bf16 to 32 U, see the
    phase);
23. train128 (after the SSL phases): the LSUN app's ``main`` at its
    defaults (full width, batch 64, 5 critic iterations, bf16) for 6
    iterations (a grid at 4, a checkpoint at 5), resumed to 8 from
    ``ckpt_5``, and 3 iterations in fp32: files, grids, 63 mask launches
    (``[64, 1024, 8, 8]``) per iteration, s/iter synchronised each step,
    peak memory; the mask kernel holds that shape bit for bit in the
    kernel phase;
24. train128_dir: ``input dir`` without ``DATA_DIR`` (the image-directory
    reader's synthetic fallback, ``prefetch``, ``stack_batches``) for 2;
25. serve_lsun128: ``apps.generate --model lsun128`` on train128's
    ``params_latest.npz``: a grid of 16, batch 256 in fp32 and ``--bf16``;
26. train64_resnet101: the 64 px app's ``ARCH resnet101`` at its defaults
    (dim 64, batch 64, bf16) for 3 iterations: no dropout, 0 mask launches;
27. train64_native: the 64 px app's ``input native`` for 2 iterations
    through ``native/ctgan_io.cpp`` built by ``data.native`` (the phase
    fails if the library did not build).

The last lines are the card, the kernel record and ``{"ok": true, ...}``.
Any failure raises and the script exits non-zero; without a CUDA device it
stops before printing any result.  It writes only under ``build/`` and
temporary directories.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from ctgan_tpu_torch.apps import ct_cifar_ssl as cifar_ssl_app
from ctgan_tpu_torch.apps import ct_gan_64x64 as app64
from ctgan_tpu_torch.apps import ct_gan_cifar as cifar_app
from ctgan_tpu_torch.apps import ct_gan_cifar_resnet as app
from ctgan_tpu_torch.apps import ct_gan_mnist as mnist_app
from ctgan_tpu_torch.apps import ct_mnist_ssl as mnist_ssl_app
from ctgan_tpu_torch.apps import generate, ssl_common
from ctgan_tpu_torch.apps import wgan_lsun128 as app128
from ctgan_tpu_torch.bridge import from_jax_params, state_from_jax, state_to_jax
from ctgan_tpu_torch.core import Randomness, precision_policy, split_params
from ctgan_tpu_torch.core.rng import SEED_SLOTS
from ctgan_tpu_torch.data import DeviceSampler, cifar10, mnist, native, synthetic_images
from ctgan_tpu_torch.eval import TrainedScorer
from ctgan_tpu_torch.kernels import (
    SOURCES,
    dropout_mask,
    dropout_mask_reference,
    philox_uniform,
    philox_uniform_reference,
)
from ctgan_tpu_torch.kernels.dropout import keep_threshold, philox4x32_10, seed_table
from ctgan_tpu_torch.kernels.build import build_libraries, library_path
from ctgan_tpu_torch.kernels.sass import disassemble, kernel_counts, op_bound_ms
from ctgan_tpu_torch.models import classifiers, dcgan, good64, lsun128, resnet_cifar
from ctgan_tpu_torch.train import (
    AcganConfig,
    AcganTrainer,
    GanConfig,
    GanState,
    GanTrainer,
    SslConfig,
    SslState,
    make_ssl_trainer,
)
from ctgan_tpu_torch.train.optim import adam_mismatches
from ctgan_tpu_torch.utils import load_checkpoint, make_grid, save_checkpoint

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
TRAIN_ITERS = 10
RESUME_ITERS = 12
ROOT = Path(__file__).resolve().parent
JAX_RUN = ROOT / "runs" / "flagship_fused_r4"
# what the JAX run logged at iteration 24999 (runs/flagship_fused_r4/log.pkl)
JAX_LOGGED = {"inception_50k": 9.70838, "fid_10k": 0.23079, "dev_cost": -0.80976}
IS_GATE = 0.30
DEV_COST_SEEDS = range(2, 10)
U = 2.0 ** -8  # bf16's unit roundoff
BF16_BOUND = 4 * U  # bf16 on the card against bf16 on the CPU: the same roundings, other sums
# A substep's gradients, card against CPU: L1 distance over the CPU's L1 mass.  In bf16 a change
# below a sum's roundoff flips later bf16 roundings: 0.071 on an H100 (PERF.md); about twice that.
BF16_GRAD_BOUND = 32 * U
# In fp32 only a ReLU on its threshold moves them: 6.3e-3 on an H100 (PERF.md); about three times that.
FP32_GRAD_BOUND = 2e-2
FP32_FLIP_BOUND = 1e-3  # fp32: gradient mass of the elements stepping the other way (1.4e-5 on an H100)
GOOD64_RUN = ROOT / "runs" / "good64_r5"
# The JAX package's inception score of runs/good64_r5/params_latest.npz on the noise, batches and
# scorer of phase_good64_checkpoint, G and scorer in fp32 on the CPU.  Reproduce with
#   python -m pytest -m slow tests/test_torch_good64.py -k is_ref
# (tests/test_torch_good64.py::jax_checkpoint_scores; FID 0.5380285601428767).
GOOD64_IS_REF = 6.381908684380933
GOOD64_IS_GATE_FP32, GOOD64_IS_GATE_BF16 = 0.05, 0.20
# what the JAX run logged at iteration 11999 (runs/good64_r5/log.pkl: bf16 on a TPU, other noise):
# a loose gate against layouts and loading (a wrong transpose scores about 1-3)
GOOD64_LOGGED_IS = 6.68983
GOOD64_LAYOUT_GATE = 1.0
GOOD64_CPU_BOUND = 1e-2  # fp32 G on the card (TF32 convs) against the CPU, on tanh outputs
TRAIN64_ITERS, RESUME64_ITERS = 10, 12


def _phase(name, fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)
    return out


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_device() -> tuple[str, float]:
    """The card's name and power limit, and its maximum SM clock in Hz."""
    smi = _smi("name,power.limit")
    clock_mhz = float(_smi("clocks.max.sm").split()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}; "
          f"SMs {torch.cuda.get_device_properties(0).multi_processor_count}; max SM clock {clock_mhz:.0f} MHz")
    return smi, clock_mhz * 1e6


def ptxas_registers(report: str) -> dict[str, int]:
    """Registers per kernel from ``-Xptxas -v``'s report."""
    registers, function = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([A-Za-z0-9_]+)'?", line)
        if m:
            function = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and function:
            registers[function] = int(m.group(1))
    return registers


def phase_build() -> None:
    for stem, report in build_libraries(SOURCES).items():
        print(f"--- nvcc {stem}\n{report}", file=sys.stderr, flush=True)
        print(f"registers ({stem}): {json.dumps(ptxas_registers(report)) if report else 'built before'}")


def flagship_mask_shapes(dim: int = 128, batch: int = 64, gen_bs_multiple: int = 2):
    """NCHW shapes of the flagship's masks: G substep, fused CT pair, GP."""
    return [(gen_bs_multiple * batch, dim, 8, 8), (4 * batch, dim, 8, 8), (batch, dim, 8, 8)]


def dev_cost_mask_shapes(dim: int = 128, n_dev: int = 640):
    """NCHW shapes of the dev cost's masks: fused CT pair over ``n_dev``
    dev examples, GP."""
    return [(4 * n_dev, dim, 8, 8), (n_dev, dim, 8, 8)]


def good64_mask_shapes(dim: int = 64, batch: int = 64):
    """NCHW shapes of the 64 px critic's masks, after its blocks 2, 3 and 4
    (keep 0.8, 0.5, 0.5): 21 launches each per 1G+5D iteration."""
    return [(batch, 4 * dim, 16, 16), (batch, 8 * dim, 8, 8), (batch, 8 * dim, 4, 4)]


def dcgan_mask_shapes(cfg) -> list[tuple]:
    """NCHW shapes of the MNIST or CIFAR-10 conv critic's masks (keep
    0.5), after its three stride-2 convs (28 -> 14 -> 7 -> 4 px, or 32 ->
    16 -> 8 -> 4): 21 launches each per 1G+5D wgan-CT iteration."""
    size = 28 if isinstance(cfg, mnist_app.Config) else 32
    shapes = []
    for mult in (1, 2, 4):
        size = -(-size // 2)
        shapes.append((cfg.BATCH_SIZE, mult * cfg.DIM, size, size))
    return shapes


# MNIST masks whose counts are no multiple of the kernel's 256-element warp span, so its tail
# path writes the rest: at batch 49, 307,328 elements (128 over: 32 whole 4-element groups), and at
# batch 49 and DIM 63, 302,526 (190 over: 47 groups and 2 elements of a 48th)
RAGGED_MASK_SHAPES = [(49, 128, 7, 7), (49, 126, 7, 7)]


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


def dequant_shapes(batch: int = 64, n_dev: int = 640):
    """Shapes of the dequantisation noise: a critic batch, the dev batch."""
    return [(batch, 3072), (n_dev, 3072)]


def _bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def ssl_mask_shapes(batch: int = 100) -> list[tuple]:
    """NCHW shapes of the semi-supervised CIFAR-10 classifier's masks (fp32):
    its input (keep 0.8), after C3 and after C6 (keep 0.5).  A step draws
    each 6 times (5 with temporal ensembling); the data-dependent init once,
    at batch 500."""
    return [(batch, 3, 32, 32), (batch, 128, 16, 16), (batch, 256, 8, 8)]


def ssl_all_mask_shapes() -> list[tuple]:
    return ssl_mask_shapes(100) + ssl_mask_shapes(500)


def ssl_masks_per_step(variant: str) -> int:
    """Mask launches of a semi-supervised step: 3 in each classifier pass,
    6 passes (D's 4: labelled, unlabelled, fake, the CT's second; G's 2) or
    5 with temporal ensembling (no second pass); MNIST has no dropout."""
    return {"mnist": 0, "cifar": 18, "te": 15}[variant]


def _mask_cases() -> list[tuple[tuple, tuple]]:
    """Every mask shape held bit for bit, with its dtypes."""
    both = (torch.float32, torch.bfloat16)
    return ([(shape, both) for shape in all_mask_shapes() + RAGGED_MASK_SHAPES]
            + [(shape, (torch.float32,)) for shape in ssl_all_mask_shapes()])


def _check_masks(device, seed: int) -> float:
    max_err = 0.0
    for shape, dtypes in _mask_cases():
        n = math.prod(shape)
        for dtype in dtypes:
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
                del got, want, again, other
    tail = dropout_mask(7, (1001,), 0.5, torch.bfloat16, device)  # ragged tail
    if not torch.equal(tail, dropout_mask_reference(7, (1001,), 0.5, torch.bfloat16, device)):
        raise AssertionError("kernel != plain version on a ragged tail")
    return max_err


def _check_table_slots(device, seed: int) -> int:
    """A draw read from slot k of a seed table equals the draw of the int
    seed that slot holds, for both kernels.  Returns the slots checked."""
    values = [seed ^ 0x5A5A5A5A, seed, 0, (1 << 32) - 1]
    table = seed_table(values, device)
    shape = flagship_mask_shapes()[1]
    for slot, value in enumerate(values):
        for dtype in (torch.float32, torch.bfloat16):
            if not torch.equal(dropout_mask(table, shape, 0.8, dtype, device, slot=slot),
                               dropout_mask(value, shape, 0.8, dtype, device)):
                raise AssertionError(f"mask from slot {slot} != mask of seed {value} ({dtype})")
        if not torch.equal(philox_uniform(table, dequant_shapes()[0], 1 / 128, device, slot=slot),
                           philox_uniform(value, dequant_shapes()[0], 1 / 128, device)):
            raise AssertionError(f"uniforms from slot {slot} != uniforms of seed {value}")
    return len(values)


def _check_uniforms(device, seed: int) -> float:
    max_err = 0.0
    for shape in dequant_shapes() + [(1001,)]:
        got = philox_uniform(seed, shape, 1 / 128, device)
        torch.cuda.synchronize()
        want = philox_uniform_reference(seed, shape, 1 / 128, device)
        max_err = max(max_err, float((got - want).abs().max()))
        if not torch.equal(got, want) or not torch.equal(got.cpu(), philox_uniform_reference(seed, shape, 1 / 128)):
            raise AssertionError(f"philox_uniform != plain version at {shape}")
        if float(got.min()) < 0 or float(got.max()) >= 1 / 128:
            raise AssertionError(f"philox_uniform outside [0, 1/128) at {shape}")
        n = got.numel()
        if abs(float(got.double().mean()) * 128 - 0.5) > 5 * math.sqrt(1 / 12 / n):
            raise AssertionError(f"philox_uniform mean {float(got.double().mean())} at {shape}")
    return max_err


def all_mask_shapes() -> list[tuple]:
    """The mask shapes of every path: the flagship's five, the 64 px
    critic's three, MNIST's and CIFAR-10's conv critics' three each, the
    128 px critic's one."""
    return (flagship_mask_shapes() + dev_cost_mask_shapes() + good64_mask_shapes()
            + dcgan_mask_shapes(mnist_app.Config()) + dcgan_mask_shapes(cifar_app.Config())
            + lsun128_mask_shapes())


def launch_shapes() -> list[tuple[str, tuple, torch.dtype]]:
    """Every (kernel, shape, dtype) the main paths launch: the mask shapes
    (``all_mask_shapes``) in fp32 and bf16, the semi-supervised ones in
    fp32, the two dequantisation shapes."""
    out = [("dropout_mask", shape, dtype) for shape in all_mask_shapes()
           for dtype in (torch.float32, torch.bfloat16)]
    out += [("dropout_mask", shape, torch.float32) for shape in ssl_all_mask_shapes()]
    return out + [("philox_uniform", shape, torch.float32) for shape in dequant_shapes()]


def _sass_key(name: str, dtype: torch.dtype) -> str:
    return name if name == "philox_uniform" else f"{name} {_dtype_name(dtype)}"


def phase_kernel(device, clock_hz: float) -> list[dict]:
    """Both kernels bit for bit against their plain versions and read from
    seed tables, then timed at every launch shape beside the library call
    and both bounds.  Returns each kernel's record for the ``kernels`` line
    (launches are added by ``main``)."""
    seed = 12345
    mask_err = _check_masks(device, seed)
    uniform_err = _check_uniforms(device, seed)
    n_slots = _check_table_slots(device, seed)
    print(f"kernel: bit for bit at {len(launch_shapes())} shapes and the ragged masks "
          f"{[(list(r), math.prod(r) % 256) for r in RAGGED_MASK_SHAPES]} (shape, elements past the last "
          f"256-element span) in both dtypes; {n_slots} table slots equal their int seeds")

    counts = kernel_counts(disassemble(library_path("dropout_mask")))
    for key, c in counts.items():
        per = {kind: round(k / c["elements"], 4) for kind, k in c["kinds"].items()}
        print(f"sass {key}: loop step of {c['elements']} elements ({c['philox_blocks']:g} Philox blocks), "
              f"{c['instructions']} instructions, by kind {json.dumps(c['kinds'])}, per element {json.dumps(per)}; "
              f"integer per Philox block {c['kinds'].get('int', 0) / c['philox_blocks']:g}; "
              f"opcodes {json.dumps(c['opcodes'])}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    table = seed_table([seed], device)
    rows = {}
    for name, shape, dtype in launch_shapes():
        n = math.prod(shape)
        reps = 200 if shape[0] <= 256 else 100
        if name == "dropout_mask":
            ms = _time_ms(lambda: dropout_mask(table, shape, 0.5, dtype, device), reps)
            library_ms = _time_ms(lambda: torch.empty(shape, dtype=dtype, device=device).bernoulli_(0.5), reps)
        else:
            ms = _time_ms(lambda: philox_uniform(table, shape, 1 / 128, device), reps)
            library_ms = _time_ms(lambda: torch.empty(shape, device=device).uniform_(0, 1 / 128), reps)
        byte_ms = _bound_ms(n * dtype.itemsize)
        op_ms, op_kind = op_bound_ms(counts[_sass_key(name, dtype)], n, sms, clock_hz)
        rows[f"{name} {list(shape)} {_dtype_name(dtype)}"] = dict(
            ms=ms, library_ms=library_ms, byte_bound_ms=byte_ms, op_bound_ms=op_ms, op_bound_kind=op_kind,
            bound_ms=max(byte_ms, op_ms), bound_by="bytes" if byte_ms >= op_ms else "operations")
    for key, r in rows.items():
        print(f"{key}: {r['ms'] * 1e3:.3f} us; library {r['library_ms'] * 1e3:.3f} us; bounds: bytes "
              f"{r['byte_bound_ms'] * 1e3:.3f} us, operations {r['op_bound_ms'] * 1e3:.3f} us "
              f"({r['op_bound_kind']}) -> {r['bound_by']}")
    print("kernel_shapes " + json.dumps(rows))

    records = []
    shape = flagship_mask_shapes()[1]  # the largest training mask: the fused CT pair
    plain_ms = _time_ms(lambda: dropout_mask_reference(seed, shape, 0.5, torch.bfloat16, device), 10)
    row = rows[f"dropout_mask {list(shape)} bfloat16"]
    print(f"dropout_mask {list(shape)} bf16: plain version {plain_ms:.5f} ms")
    records.append(dict(
        name="dropout_mask", route="cuda", source="ctgan_tpu_torch/csrc/dropout_mask.cu",
        replaces="ctgan_tpu/kernels/dropout.py:35", max_abs_err=mask_err, ms=row["ms"], plain_ms=plain_ms,
        bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"]))

    shape = dequant_shapes()[0]  # one critic substep's dequantisation noise
    plain_ms = _time_ms(lambda: philox_uniform_reference(seed, shape, 1 / 128, device), 10)
    row = rows[f"philox_uniform {list(shape)} float32"]
    print(f"philox_uniform {list(shape)}: plain version {plain_ms:.5f} ms")
    records.append(dict(
        name="philox_uniform", route="cuda", source="ctgan_tpu_torch/csrc/dropout_mask.cu",
        replaces="ctgan_tpu/train/trainer_acgan.py:228", max_abs_err=uniform_err, ms=row["ms"],
        plain_ms=plain_ms, bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"]))
    return records


class _TableDraws:
    """The Philox draws of a provider from the seed table ``seeds``, slot by
    slot in the order they are asked for; the host draws (noise, labels, GP
    alphas) are left out as None.  What a captured iteration launches."""

    def __init__(self, seeds: torch.Tensor, device):
        self.seeds, self.device, self.slot = seeds, torch.device(device), 0

    def _take(self) -> int:
        self.slot += 1
        return self.slot - 1

    def dropout_mask(self, shape, keep_prob, dtype, device):
        return dropout_mask(self.seeds, shape, keep_prob, dtype, device, slot=self._take())

    def dequant(self, shape):
        return philox_uniform(self.seeds, tuple(shape), 1.0 / 128, self.device, slot=self._take())

    def noise(self, *args):
        return None

    labels = gp_alpha = noise


def table_draws_equal(captured: list, eager: list) -> int:
    """Compares the table's draws with a provider's eager draws of the same
    iteration where the table drew; returns how many were compared."""
    compared = 0
    for i, (c, e) in enumerate(zip(captured, eager, strict=True)):
        if c is None:
            continue
        if c.dtype != e.dtype or not torch.equal(c, e):
            raise AssertionError(f"draw {i}: the table's draw != the provider's eager draw")
        compared += 1
    return compared


def phase_capture(device, seed: int = 0, cfg: app.Config | None = None, steps=(0, 1, 781)) -> dict:
    """One iteration's Philox draws captured in a CUDA graph against a
    static seed table, replayed with each step's seeds copied in, each draw
    equal to ``Randomness(seed).for_step(step)``'s eager one bit for bit;
    then a replay's time against the eager launches."""
    device = torch.device(device)
    cfg = cfg or app.Config()
    static = torch.zeros(SEED_SLOTS, dtype=torch.int32, device=device)
    _iteration_draws(_TableDraws(static, device), device, cfg)  # loads and sizes the kernels first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = dropout_mask.launches, philox_uniform.launches
    with torch.cuda.graph(graph):
        captured = _iteration_draws(_TableDraws(static, device), device, cfg)
    launched = dropout_mask.launches - before[0], philox_uniform.launches - before[1]
    n_critic = cfg.N_CRITIC
    if launched != (3 + 6 * n_critic, n_critic):
        raise AssertionError(f"the capture launched {launched} kernels, expected {(3 + 6 * n_critic, n_critic)}")
    for step in steps:
        rand = Randomness(seed, device).for_step(step)
        eager = _iteration_draws(rand, device, cfg)
        static.copy_(rand.seeds)
        graph.replay()
        torch.cuda.synchronize()
        compared = table_draws_equal(captured, eager)
        if compared != sum(launched):
            raise AssertionError(f"compared {compared} draws at step {step}")
    eager_fn = lambda: _iteration_draws(_TableDraws(static, device), device, cfg)
    # 10 eager iterations enqueue within _time_ms's sleep, so the events time the device's work
    times = {"replay_device_ms": _time_ms(graph.replay, 50), "eager_device_ms": _time_ms(eager_fn, 10)}
    for key, fn, reps in (("replay_host_ms", graph.replay, 50), ("eager_host_ms", eager_fn, 10)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times[key] = (time.perf_counter() - t0) / reps * 1e3  # enqueue only
        torch.cuda.synchronize()
    print(f"capture: {sum(launched)} draws ({launched[0]} masks, {launched[1]} uniforms) in one graph, replayed at "
          f"steps {list(steps)}, each equal to the eager draws bit for bit; per iteration: replay "
          f"{times['replay_device_ms'] * 1e3:.3f} us device, {times['replay_host_ms'] * 1e3:.3f} us host; "
          f"{sum(launched)} eager launches {times['eager_device_ms'] * 1e3:.3f} us device, "
          f"{times['eager_host_ms'] * 1e3:.3f} us host")
    del graph, captured
    return dict(draws=sum(launched), steps=list(steps), **times)


def _iteration_draws(rand, device, cfg: app.Config) -> list:
    """Every draw of one flagship iteration, in the trainer's order (bf16
    masks, the default): the G substep's labels, noise and 3 masks; each
    critic substep's dequantisation noise, the fakes' noise, the CT pair's 3
    masks, the GP alphas and the GP pass's 3 masks."""
    g_shape, pair, gp = flagship_mask_shapes(cfg.DIM_D, cfg.BATCH_SIZE, cfg.GEN_BS_MULTIPLE)
    masks = lambda shape: [rand.dropout_mask(shape, kp, torch.bfloat16, device) for kp in (0.8, 0.5, 0.5)]
    out = [rand.labels(g_shape[0], 10), rand.noise(g_shape[0], 128), *masks(g_shape)]
    for _ in range(cfg.N_CRITIC):
        out += [rand.dequant((cfg.BATCH_SIZE, 3072)), rand.noise(cfg.BATCH_SIZE, 128), *masks(pair)]
        out += [rand.gp_alpha(cfg.BATCH_SIZE), *masks(gp)]
    return out


class _MaskSeeds:
    """``rand`` with its dropout masks left undrawn: each mask takes its
    Philox seed in its turn, as the provider would, and comes back as
    ``(seed, shape, keep_prob, dtype)``."""

    def __init__(self, rand: Randomness):
        self.rand = rand

    def __getattr__(self, kind):
        return getattr(self.rand, kind)

    def dropout_mask(self, shape, keep_prob, dtype, device):
        return (int(self.rand.seed_values[self.rand.take_slot()]), tuple(shape), keep_prob, dtype)


def plain_mask_at(seed: int, keep_prob: float, dtype: torch.dtype, index: torch.Tensor) -> torch.Tensor:
    """Elements ``index`` of the flattened plain mask of ``seed``: element
    ``i`` is word ``i % 4`` of Philox on counter ``i // 4``."""
    bits = philox4x32_10(index // 4, seed).gather(-1, (index % 4)[:, None])[:, 0]
    scale = torch.tensor(np.float32(1.0 / keep_prob))
    return torch.where(bits < keep_threshold(keep_prob), scale, torch.zeros(())).to(dtype)


def _slice_index(n: int, k: int = 8192) -> torch.Tensor:
    """The first and last ``k`` of ``n`` elements and ``k`` spread between."""
    return torch.unique(torch.cat([torch.arange(min(k, n)), torch.arange(max(n - k, 0), n),
                                   torch.arange(0, n, max(n // k, 1))]))


def phase_draws(device, seed: int = 0, cfg: app.Config | None = None) -> dict:
    """The flagship run's draws on the card against the CPU, bit for bit:
    the sampler's permutations of epochs 0 and 1 (50,000 examples) and
    every draw of ``Randomness(seed).for_step(k)`` for the first two
    iterations and the first of epoch 1.  Iteration 0's masks are compared
    whole; the later ones at ``_slice_index`` of each mask, from the plain
    Philox at those elements (``plain_mask_at``), which bounds the CPU's
    work (the kernel phase holds whole masks at every shape).  Then the
    host's cost per iteration of the draws the CPU makes (noise, labels, GP
    alphas, each copied from pinned memory)."""
    device = torch.device(device)
    cfg = cfg or app.Config()
    arrays = [np.zeros((cfg.n_examples, 1), np.uint8)]
    samplers = [DeviceSampler(arrays, cfg.BATCH_SIZE, cfg.N_CRITIC, seed=seed, device=d) for d in (device, "cpu")]
    for epoch in (0, 1):
        got, want = (s.epoch_perm(epoch) for s in samplers)
        if got.device.type != device.type or not torch.equal(got.cpu(), want):
            raise AssertionError(f"epoch {epoch}'s permutation differs between {device} and cpu")
    steps = (0, 1, samplers[1].iters_per_epoch)
    n_draws = n_sliced = 0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the plain Philox's int64 ops ran slower on more threads
    try:
        for step in steps:
            got = _iteration_draws(Randomness(seed, device).for_step(step), device, cfg)
            cpu = Randomness(seed, "cpu").for_step(step)
            want = _iteration_draws(cpu if step == 0 else _MaskSeeds(cpu), "cpu", cfg)
            for i, (g, w) in enumerate(zip(got, want)):
                if isinstance(w, tuple):
                    mask_seed, shape, kp, dtype = w
                    index = _slice_index(math.prod(shape))
                    g = g.reshape(-1)[index.to(device)]
                    w = plain_mask_at(mask_seed, kp, dtype, index)
                    n_sliced += 1
                if g.device.type != device.type or g.dtype != w.dtype or not torch.equal(g.cpu(), w):
                    raise AssertionError(f"draw {i} of step {step} differs between {device} and cpu")
            n_draws += len(want)
    finally:
        torch.set_num_threads(threads)

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    reps = 20
    sync()
    t0 = time.perf_counter()
    for step in range(reps):
        rand = Randomness(seed, device).for_step(step)
        rand.labels(cfg.GEN_BS_MULTIPLE * cfg.BATCH_SIZE, 10)
        rand.noise(cfg.GEN_BS_MULTIPLE * cfg.BATCH_SIZE, 128)
        for _ in range(cfg.N_CRITIC):
            rand.noise(cfg.BATCH_SIZE, 128)
            rand.gp_alpha(cfg.BATCH_SIZE)
    sync()
    host_small_ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"draws: {n_draws} draws at steps {list(steps)} ({n_sliced} masks compared at slices) and 2 epoch "
          f"permutations equal on {device} and cpu; host ms per iteration for noise, labels and GP alphas "
          f"{host_small_ms:.3f}")
    return dict(n_draws=n_draws, n_sliced=n_sliced, host_small_ms=host_small_ms)


def _copy_state(state, device):
    """A copy of a trainer state on ``device`` (never sharing storage)."""
    params = lambda p: {k: v.detach().to(device, copy=True).requires_grad_(True) for k, v in p.items()}
    opt = lambda o: {"m": {k: v.to(device, copy=True) for k, v in o["m"].items()},
                     "v": {k: v.to(device, copy=True) for k, v in o["v"].items()}, "t": o["t"]}
    return type(state)(params(state.gen_params), params(state.disc_params), opt(state.gen_opt),
                       opt(state.disc_opt), state.step)


def _lockstep(device, params, mcfg, acfg: AcganConfig, *, iters, seed, check) -> None:
    """``iters`` flagship iterations on the CPU, substep by substep; before
    each substep the CPU's state is copied to ``device`` and the substep
    runs there too, with the same draws (two providers of one seed, asked
    in the same order).  ``check(network, state_before, dev_state,
    cpu_state, dev_metrics, cpu_metrics)`` compares the two after each
    substep, so a difference is held to one substep and not carried into
    the next."""
    trainer = AcganTrainer(
        lambda p, n, labels, rand, noise=None: resnet_cifar.generator(p, n, labels, mcfg, rand, noise=noise),
        lambda p, x, labels, kps, rand: resnet_cifar.discriminator(p, x, labels, kps, mcfg, rand),
        acfg,
    )
    gen, disc, _ = split_params(from_jax_params(params), "Generator", "Discriminator")
    state = trainer.init_state(gen, disc)
    data = np.random.default_rng(seed)
    rand_dev, rand_cpu = Randomness(seed, device), Randomness(seed, "cpu")
    n_critic, batch = acfg.critic_iters, acfg.batch_size
    for _ in range(iters):
        real = torch.from_numpy(data.integers(0, 256, (n_critic, batch, 3072), dtype=np.uint8))
        labels = torch.from_numpy(data.integers(0, 10, (n_critic, batch)))
        before, dev = _copy_state(state, "cpu"), _copy_state(state, device)
        got = {"gen_cost": trainer.gen_substep(dev, rand_dev)}
        want = {"gen_cost": trainer.gen_substep(state, rand_cpu)}
        check("gen", before, dev, state, got, want)
        for i in range(n_critic):
            before, dev = _copy_state(state, "cpu"), _copy_state(state, device)
            got = trainer.critic_substep(dev, real[i].to(device), labels[i].to(device), rand_dev)
            want = trainer.critic_substep(state, real[i], labels[i], rand_cpu)
            check("disc", before, dev, state, got, want)
        state.step += 1


def _one_batch(device, params, mcfg, seed: int) -> list[torch.Tensor]:
    """G's samples from fixed noise and labels, and D's outputs on them."""
    data = np.random.default_rng(seed)
    noise = torch.from_numpy(data.normal(size=(8, 128)).astype(np.float32)).to(device)
    labels = torch.from_numpy(data.integers(0, 10, 8)).to(device)
    tensors = {k: v.to(device) for k, v in from_jax_params(params).items()}
    rand = Randomness(seed, device)
    with torch.no_grad():
        fake = resnet_cifar.generator(tensors, 8, labels, mcfg, rand, noise=noise)
        out = resnet_cifar.discriminator(tensors, fake, labels, (0.8, 0.5, 0.5), mcfg, rand)
    return [t.float().cpu() for t in (fake, *out)]


def _substep_checker(device, *, bf16: bool, lr: float, beta1: float, zero_grad, elementwise: bool = True,
                     bf16_loss_bound: float = BF16_BOUND):
    """``check(network, state_before, dev_state, cpu_state, dev_metrics,
    cpu_metrics)`` for ``_lockstep``/``_lockstep_gan``, with the report it
    fills and the failures it collects (the bounds of
    ``phase_cuda_vs_cpu``; ``elementwise=False`` leaves out its elementwise
    check of iteration 0's params; ``bf16_loss_bound`` is the losses' bound
    in bf16).  A substep's gradient is read back from TF-Adam's first
    moment: ``(m - beta1 * m_before) / (1 - beta1)``."""
    tol = (dict(rel_tol=bf16_loss_bound, abs_tol=bf16_loss_bound) if bf16
           else dict(rel_tol=1e-3, abs_tol=1e-5))
    grad_bound, flip_bound = (BF16_GRAD_BOUND, BF16_BOUND) if bf16 else (FP32_GRAD_BOUND, FP32_FLIP_BOUND)
    report = {"diff": 0.0, "moved": 0, "total": 0, "grad_l1": 0.0, "flipped_mass": 0.0}
    failures = []

    def grad(opt, before, k):
        m = opt["m"][k].detach().cpu().numpy().astype(np.float64)
        return (m - beta1 * before["m"][k].numpy().astype(np.float64)) / (1.0 - beta1)

    def check(network, before, dev, cpu, got, want):
        at = f"{network} substep at step {cpu.step}"
        for k, w in want.items():
            if bf16 and k.startswith("acc_"):
                continue
            if not math.isclose(float(got[k]), float(w), **tol):
                failures.append(f"{at}: {k} {float(got[k])} on {device} vs {float(w)} on cpu")
        if network == "gen" and cpu.step == 0:
            return  # the G update of step 0 is dropped
        field, opt = ("gen_params", "gen_opt") if network == "gen" else ("disc_params", "disc_opt")
        ours = {k: v.detach().cpu().numpy() for k, v in getattr(dev, field).items()}
        theirs = {k: v.detach().numpy() for k, v in getattr(cpu, field).items()}
        start = {k: v.detach().numpy() for k, v in getattr(before, field).items()}
        if elementwise and not bf16 and cpu.step == 0:
            bad = adam_mismatches(ours, theirs, lr=lr, n_updates=1, zero_grad=zero_grad)
            if bad:
                failures.append(f"{at}: params {bad}")
        mass = flipped = grad_l1 = 0.0
        for k in theirs:
            diff = np.abs(ours[k] - theirs[k])
            report["diff"] = max(report["diff"], float(diff.max()))
            report["moved"] += int(np.sum(diff > 1e-6))
            report["total"] += diff.size
            other_way = np.sign(ours[k] - start[k]) != np.sign(theirs[k] - start[k])
            g = grad(getattr(cpu, opt), getattr(before, opt), k)
            grad_l1 += float(np.sum(np.abs(grad(getattr(dev, opt), getattr(before, opt), k) - g)))
            flipped += float(np.sum(np.abs(g[other_way])))
            mass += float(np.sum(np.abs(g)))
        report["grad_l1"] = max(report["grad_l1"], grad_l1 / mass)
        report["flipped_mass"] = max(report["flipped_mass"], flipped / mass)
        if grad_l1 > grad_bound * mass:
            failures.append(f"{at}: gradients {grad_l1 / mass:.3g} of the CPU's L1 mass apart (> {grad_bound:.3g})")
        if flipped > flip_bound * mass:
            failures.append(f"{at}: elements carrying {flipped / mass:.3g} of the gradient's mass stepped "
                            f"the other way (> {flip_bound:.3g})")

    return check, report, failures


@contextlib.contextmanager
def _no_tf32():
    """fp32 convolutions in full fp32 on the card (cuDNN's default is TF32)."""
    old = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


def _lockstep_report(what: str, device, precision: str, iters: int, report: dict, failures: list) -> float:
    line = (f"{what}{device} vs cpu in {precision}, {iters} iterations substep by substep: max param diff "
            f"{report['diff']:.3g}, {report['moved'] / max(report['total'], 1):.5f} of the updated elements "
            f"beyond 1e-6; at most {report['grad_l1']:.3g} of a substep's gradient mass apart, "
            f"{report['flipped_mass']:.3g} stepping the other way")
    print(line)
    if failures:
        raise AssertionError(f"{line}\n" + "\n".join(failures))
    return report["diff"]


def phase_cuda_vs_cpu(device, *, precision="float32", dim=16, batch=4, n_critic=2, iters=2,
                      seed=0) -> float:
    """``iters`` iterations on ``device`` against the CPU with the same
    draws, under ``precision``, each substep from the same state
    (``_lockstep``): a rounding difference that flips the sign of a tiny
    gradient moves that parameter by 2 lr, and carried into the next
    substeps it moves every later gradient.  Per substep the losses, the
    gradient (TF-Adam's first moment holds it at beta1 = 0) and the
    updated params are compared:

    * fp32, with TF32 off: the losses to rtol 1e-3.  In iteration 0 (the
      two D updates from the initial state) the params by
      ``adam_mismatches`` (atol 1e-6, 2 * lr allowance for Adam steps on
      gradients that are zero up to rounding).  In every substep the L1
      distance of the gradients within ``FP32_GRAD_BOUND`` of the CPU
      gradient's L1 mass, and the elements that stepped the other way
      carrying at most ``FP32_FLIP_BOUND`` of it.  Not elementwise after
      iteration 0: there a ReLU input of this dim-16 run lies within 1e-6
      of zero, cuDNN's forward, 1e-7 from the CPU's, switches it, as a 1e-6
      perturbation of the CPU's own forward does, and G's gradient moves
      by 2.5% of its largest element (measured on an H100 and reproduced on
      the CPU; PERF.md).
    * bf16: first G's samples and D's outputs on one batch, each within
      ``BF16_BOUND`` (4 bf16 roundoffs) of its largest magnitude: the two
      devices round at the same points and sum in other orders.  Then the
      losses to ``BF16_BOUND`` relative (absolute for the WGAN difference;
      the accuracies are left out, a rounding can move an argmax), the
      gradients' L1 distance within ``BF16_GRAD_BOUND`` of the CPU
      gradient's mass, and the elements that stepped the other way carrying
      at most ``BF16_BOUND`` of it: in bf16 a gradient smaller than its
      rounding error may take either sign.

    Every substep runs before a failure is raised, so the message holds
    the largest shares.  Returns the largest param difference."""
    mcfg = resnet_cifar.ResnetCifarConfig(dim_g=dim, dim_d=dim)
    acfg = AcganConfig(batch_size=batch, critic_iters=n_critic, iters=100)
    params = resnet_cifar.init_params(mcfg, seed)
    bf16 = precision == "bfloat16"
    check, report, failures = _substep_checker(device, bf16=bf16, lr=acfg.lr, beta1=acfg.beta1,
                                               zero_grad=resnet_cifar.zero_grad_params(mcfg))
    with precision_policy(precision):
        if bf16:
            for i, (g, w) in enumerate(zip(_one_batch(device, params, mcfg, seed),
                                           _one_batch("cpu", params, mcfg, seed))):
                dev = float((g - w).abs().max() / w.abs().max())
                if dev > BF16_BOUND:
                    raise AssertionError(f"bf16 output {i} on {device} vs cpu: {dev:.3g} of its scale")
        with _no_tf32():
            _lockstep(device, params, mcfg, acfg, iters=iters, seed=seed, check=check)
    return _lockstep_report("", device, precision, iters, report, failures)


def _good64_trainer(dim: int, gcfg: GanConfig) -> GanTrainer:
    return GanTrainer(
        lambda p, n, rand, noise=None: good64.generator(p, n, rand, dim=dim, noise=noise),
        lambda p, x, rand: good64.discriminator(p, x, rand, dim=dim, mode=gcfg.mode),
        gcfg,
    )


def _lockstep_gan(device, trainer: GanTrainer, params, *, iters, seed, check, real_dim: int = 3 * 64 * 64,
                  low: float = -1.0) -> None:
    """``_lockstep`` for the unconditional trainer: ``[B, real_dim]`` reals
    in ``[low, 1]`` of a seeded NumPy draw, each substep on the CPU and on
    ``device`` from the same state with the same draws."""
    gen, disc, _ = split_params(from_jax_params(params), "Generator", "Discriminator")
    state = trainer.init_state(gen, disc)
    data = np.random.default_rng(seed)
    rand_dev, rand_cpu = Randomness(seed, device), Randomness(seed, "cpu")
    n_critic, batch = trainer.cfg.critic_iters, trainer.cfg.batch_size
    for _ in range(iters):
        real = torch.from_numpy(data.uniform(low, 1, (n_critic, batch, real_dim)).astype(np.float32))
        before, dev = _copy_state(state, "cpu"), _copy_state(state, device)
        got = {"gen_cost": trainer.gen_substep(dev, rand_dev)}
        want = {"gen_cost": trainer.gen_substep(state, rand_cpu)}
        check("gen", before, dev, state, got, want)
        for i in range(n_critic):
            before, dev = _copy_state(state, "cpu"), _copy_state(state, device)
            got = trainer.critic_substep(dev, real[i].to(device), rand_dev)
            want = trainer.critic_substep(state, real[i], rand_cpu)
            check("disc", before, dev, state, got, want)
        state.step += 1


def phase_cuda_vs_cpu_gan(device, *, precision="float32", mode="wgan-ct", dim=16, batch=4, n_critic=2,
                          iters=2, seed=0) -> float:
    """``phase_cuda_vs_cpu`` for the unconditional trainer and the 64 px
    "Good" ResNet at ``dim``, ``mode`` (wgan-ct: layer norm in D; wgan-gp:
    batch norm, whose CPU form the port writes out), with the same bounds on
    the losses and on each substep's gradient mass.  Two checks are left
    out, because correct runs miss them: the elementwise check of iteration
    0's params (with batch norm in D, 0.34% of a tensor's elements had
    gradients within rounding of zero and stepped the other way, on an
    H100; the gradient mass they carry, 2.4e-5, is what the bound holds),
    and the one-batch bf16 check of G and D (a rounding that lands the
    other way under G's batch norm over 4 images carries into every later
    element: 24 U between correct bf16 runs on the CPU,
    tests/test_torch_good64.py)."""
    gcfg = GanConfig(mode=mode, batch_size=batch, critic_iters=n_critic, iters=100)
    trainer = _good64_trainer(dim, gcfg)
    bf16 = precision == "bfloat16"
    check, report, failures = _substep_checker(device, bf16=bf16, lr=gcfg.lr, beta1=gcfg.beta1,
                                               zero_grad=good64.zero_grad_params(mode), elementwise=False)
    with precision_policy(precision), _no_tf32():
        _lockstep_gan(device, trainer, good64.init_params(dim, mode, seed), iters=iters, seed=seed, check=check)
    return _lockstep_report(f"good64 {mode}: ", device, precision, iters, report, failures)


def phase_cuda_vs_cpu_dcgan(device, *, precision="float32", dim=64, batch=50, n_critic=2, iters=2,
                            seed=0) -> float:
    """``phase_cuda_vs_cpu_gan`` for the MNIST conv GAN at full width (dim
    64, batch 50, wgan-CT: no batch norm in G or D, dropout at keep 0.5
    after each of D's three convs), reals in [0, 1], with its bounds."""
    mode = "wgan-CT"
    gcfg = GanConfig(mode=mode, batch_size=batch, critic_iters=n_critic, iters=100)
    trainer = GanTrainer(
        lambda p, n, rand, noise=None: dcgan.mnist_generator(p, n, rand, dim=dim, mode=mode, noise=noise),
        lambda p, x, rand: dcgan.mnist_discriminator(p, x, rand, dim=dim, mode=mode),
        gcfg,
    )
    bf16 = precision == "bfloat16"
    check, report, failures = _substep_checker(device, bf16=bf16, lr=gcfg.lr, beta1=gcfg.beta1,
                                               zero_grad=dcgan.zero_grad_params("mnist", mode), elementwise=False)
    with precision_policy(precision), _no_tf32():
        _lockstep_gan(device, trainer, dcgan.init_params("mnist", dim, mode, seed), iters=iters, seed=seed,
                      check=check, real_dim=784, low=0.0)
    return _lockstep_report(f"mnist {mode} dim {dim} batch {batch}: ", device, precision, iters, report, failures)


class _Tee(io.TextIOBase):
    """Writes to stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, text):
        self.buf.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _run_main(cfg: app.Config, device) -> tuple:
    """``app.main`` with the kernels' launches counted and stdout kept.
    Returns (state, records, launches of the mask kernel, launches of the
    uniform kernel, stdout, seconds)."""
    dropout_mask.launches = philox_uniform.launches = 0
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        state, records = app.main(cfg=cfg, device=device)
    return (state, records, dropout_mask.launches, philox_uniform.launches, tee.buf.getvalue(),
            time.perf_counter() - t0)


def _test_iterations(cfg, start: int) -> list[int]:
    """The iterations from ``start`` on whose ``test_fn`` runs (any app's
    config with ``ITERS`` and ``sample_every``)."""
    return [it for it in range(start, cfg.ITERS) if it % cfg.sample_every == cfg.sample_every - 1]


def _expected_launches(cfg: app.Config, start: int, device) -> int:
    """Per iteration: G substep 3 masks; each critic substep 3 (CT pair) +
    3 (GP); the kp=1 clean pass makes none.  Per test_fn: the dev cost's
    3 + 3; G has no dropout."""
    if torch.device(device).type != "cuda":
        return 0
    return (cfg.ITERS - start) * (3 + 6 * cfg.N_CRITIC) + 6 * len(_test_iterations(cfg, start))


def _expected_uniform_launches(cfg: app.Config, start: int, device) -> int:
    """The dequantisation noise: one draw per critic substep and one per
    test_fn's dev cost."""
    if torch.device(device).type != "cuda":
        return 0
    return (cfg.ITERS - start) * cfg.N_CRITIC + len(_test_iterations(cfg, start))


def decode_png(path) -> np.ndarray:
    """The pixels of an 8-bit grayscale or RGB PNG without interlace (what
    ``utils.images.save_images`` writes), with every chunk's CRC checked."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise AssertionError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, color, _, _, interlace = header
    channels = {0: 1, 2: 3}[color]
    if depth != 8 or interlace:
        raise AssertionError(f"{path}: unexpected PNG header {header}")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * channels)
    if raw[:, 0].any():
        raise AssertionError(f"{path}: row filters other than none")
    return raw[:, 1:].reshape((h, w, channels) if channels == 3 else (h, w))


def phase_train(device, cfg: app.Config) -> dict:
    """One ``main`` from a fresh ``cfg.out_dir``: launches, files, grids,
    finite metrics, generator samples."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state, records, launches, uniforms, stdout, seconds = _run_main(cfg, device)
    fit = re.search(r"IS scorer: fitted in ([0-9.]+) s", stdout)
    expected = (_expected_launches(cfg, 0, device), _expected_uniform_launches(cfg, 0, device))
    if (launches, uniforms) != expected:
        raise AssertionError(f"dropout_mask, philox_uniform launched {launches}, {uniforms} times, "
                             f"expected {expected}")
    if cfg.NORMALIZATION_D != ("Discriminator.2.N1.scale" in state.disc_params):
        raise AssertionError("D's layer norms do not follow NORMALIZATION_D")
    out = Path(cfg.out_dir)
    saves = list(range(cfg.save_every, cfg.ITERS + 1, cfg.save_every))
    tests = _test_iterations(cfg, 0)
    files = [f"ckpt/ckpt_{n}.npz" for n in saves[-5:]] + ["log.pkl", "log.ndjson"]
    files += ["params_latest.npz"] if saves else []
    files += [f"samples_{it}.png" for it in tests]
    missing = [f for f in files if not (out / f).is_file()]
    if missing:
        raise AssertionError(f"missing in out_dir: {missing}")
    for it in tests:
        grid = decode_png(out / f"samples_{it}.png")
        if grid.shape != (320, 320, 3):
            raise AssertionError(f"samples_{it}.png is {grid.shape}, not a 10x10 grid of 32x32 RGB")
    last = records[-1]
    for k in ("wgan", "ct", "gp", "acgan", "gen_cost"):
        if not math.isfinite(last[k]):
            raise AssertionError(f"{k} = {last[k]}")
    evals = [r for r in records if "inception_50k" in r]
    for r in evals:
        if not (math.isfinite(r["inception_50k"]) and math.isfinite(r["fid_10k"])
                and 1.0 <= r["inception_50k"] <= 10.0):
            raise AssertionError(f"IS/FID out of range: {r}")
    mcfg = resnet_cifar.ResnetCifarConfig(dim_g=cfg.DIM_G, dim_d=cfg.DIM_D)
    with torch.no_grad():
        labels = torch.arange(100, device=device) % 10
        samples = resnet_cifar.generator(state.gen_params, 100, labels, mcfg, Randomness(1, device))
    want_dtype = torch.bfloat16 if cfg.BF16 and device.type == "cuda" else torch.float32
    if samples.dtype != want_dtype:
        raise AssertionError(f"generator samples are {samples.dtype}, not {want_dtype}")
    if samples.shape != (100, 3072) or not bool(torch.isfinite(samples).all()) or samples.abs().max() > 1:
        raise AssertionError("generator samples are not finite [100, 3072] values in [-1, 1]")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    steps = [r["time"] for r in records if 1 <= r["iteration"] <= 3]
    return dict(launches=launches, uniform_launches=uniforms,
                s_per_iter=float(np.mean(steps)) if steps else None,
                peak_bytes=peak, last=last, seconds=seconds, evals=evals,
                scorer_fit_s=float(fit.group(1)) if fit else None)


def phase_resume(device, cfg: app.Config) -> dict:
    """``main`` again in the same ``out_dir`` with more iterations: it must
    resume where the last checkpoint left off and train on."""
    start = cfg.ITERS - cfg.ITERS % cfg.save_every if cfg.save_every else 0
    more = dataclasses.replace(cfg, ITERS=cfg.ITERS + (RESUME_ITERS - TRAIN_ITERS))
    state, records, launches, uniforms, stdout, seconds = _run_main(more, device)
    want = f"resumed from {Path(cfg.out_dir) / 'ckpt' / f'ckpt_{start}.npz'} at iteration {start}"
    if want not in stdout:
        raise AssertionError(f"no line {want!r} in the resumed run's output")
    expected = (_expected_launches(more, start, device), _expected_uniform_launches(more, start, device))
    if (launches, uniforms) != expected:
        raise AssertionError(f"dropout_mask, philox_uniform launched {launches}, {uniforms} times on "
                             f"resume, expected {expected}")
    if state.step != more.ITERS or records[-1]["iteration"] != more.ITERS - 1:
        raise AssertionError(f"resumed run ended at step {state.step}, records {records[-1]}")
    return dict(launches=launches, uniform_launches=uniforms, seconds=seconds, start=start, line=want)


def phase_resume_equal(device, *, precision="float32", dim=16, batch=4, n_critic=2, iters=4,
                       seed=0) -> float:
    """``iters`` iterations uninterrupted, against ``iters // 2``, a
    checkpoint written and read back into a fresh trainer, and the rest;
    cuDNN deterministic, under ``precision``.  Params by
    ``adam_mismatches``.  Returns the largest param difference."""
    device = torch.device(device)
    mcfg = resnet_cifar.ResnetCifarConfig(dim_g=dim, dim_d=dim)
    params = resnet_cifar.init_params(mcfg, seed)
    data = np.random.default_rng(seed)
    images = data.integers(0, 256, (64, 3072), dtype=np.uint8)
    labels = data.integers(0, 10, 64)

    def fresh():
        trainer = AcganTrainer(
            lambda p, n, lab, rand, noise=None: resnet_cifar.generator(p, n, lab, mcfg, rand, noise=noise),
            lambda p, x, lab, kps, rand: resnet_cifar.discriminator(p, x, lab, kps, mcfg, rand),
            AcganConfig(batch_size=batch, critic_iters=n_critic, iters=100),
        )
        tensors = {k: v.to(device) for k, v in from_jax_params(params).items()}
        gen, disc, _ = split_params(tensors, "Generator", "Discriminator")
        return trainer, trainer.init_state(gen, disc)

    sampler = DeviceSampler([images, labels], batch, n_critic, seed=seed, device=device)
    rand = Randomness(seed, device)

    def run(trainer, state, start, stop):
        for it in range(start, stop):
            trainer.step(state, *sampler.sample(it), rand.for_step(state.step))

    with precision_policy(precision):
        old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            trainer, whole = fresh()
            run(trainer, whole, 0, iters)
            trainer, first = fresh()
            run(trainer, first, 0, iters // 2)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as tmp:
                path = save_checkpoint(os.path.join(tmp, "ckpt.npz"), {"state": state_to_jax(first)})
                trainer, _ = fresh()
                resumed = state_from_jax(load_checkpoint(path)["state"], device)
            run(trainer, resumed, iters // 2, iters)
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old
    got = state_to_jax(resumed)
    want = state_to_jax(whole)
    got_p = {**got["gen_params"], **got["disc_params"]}
    want_p = {**want["gen_params"], **want["disc_params"]}
    bad = adam_mismatches(got_p, want_p, lr=trainer.cfg.lr, n_updates=iters * n_critic,
                          zero_grad=resnet_cifar.zero_grad_params(mcfg))
    if bad or not int(got["step"]) == int(want["step"]) == iters:
        raise AssertionError(f"resumed run differs from the uninterrupted one: {bad}")
    diff = max(float(np.abs(got_p[k] - want_p[k]).max()) for k in want_p)
    print(f"resume_equal on {device} in {precision}: {iters // 2} + checkpoint + "
          f"{iters - iters // 2} iterations vs {iters}: max param diff {diff:.3g}")
    return diff


def _sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _score(test_fn, state, device) -> dict:
    """``test_fn`` at iteration 24998 (dev cost and grid) and 24999 (with
    IS and FID), timed, under the precision policy in force."""
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    quick = test_fn(state, 24998)  # returns host floats: synchronised
    test_s = time.perf_counter() - t0
    test_peak = torch.cuda.max_memory_allocated(device) - base
    t0 = time.perf_counter()
    full = test_fn(state, 24999)
    return dict(quick=quick, eval=full, test_s=test_s, eval_s=time.perf_counter() - t0,
                test_peak_bytes=test_peak)


def phase_jax_checkpoint(device, out_dir: str) -> dict:
    """The JAX run's dim-128 checkpoint scored by the port as the JAX app
    scored it at iteration 24999, in bf16 (the app's default on the card;
    the JAX run too scored in bf16) and in fp32; then ``apps.generate`` on
    it, in fp32 and with ``--bf16``.  Card only."""
    device = torch.device(device)
    ckpt, scorer_path = JAX_RUN / "ckpt" / "ckpt_25000.npz", JAX_RUN / "scorer.npz"
    for path in (ckpt, scorer_path):
        print(f"sha256 {path.relative_to(ROOT)} {_sha256(path)}")
    cfg = app.Config(out_dir=out_dir)
    flagship = app.setup(cfg, device)
    blob = load_checkpoint(str(ckpt))
    if (blob["loop"]["iteration"], blob["data_state"]["i"]) != (25000, 25000):
        raise AssertionError(f"unexpected loop/data state {blob['loop']} {blob['data_state']}")
    state = state_from_jax(blob["state"], device)
    for field in ("gen_params", "disc_params"):
        got = {k: tuple(v.shape) for k, v in getattr(state, field).items()}
        want = {k: tuple(v.shape) for k, v in getattr(flagship.state, field).items()}
        if got != want:
            raise AssertionError(f"{field} of the JAX checkpoint do not match the port's model")
    scorer = TrainedScorer(3, 32, cache_path=str(scorer_path), device=device)
    test_fn = app.make_test_fn(cfg, flagship, scorer, out_dir)

    dropout_mask.launches = philox_uniform.launches = 0
    scores = {}
    for precision in ("bfloat16", "float32"):
        with precision_policy(precision):
            scores[precision] = _score(test_fn, state, device)
    # the dev cost's spread over its draws (fake noise and labels, dropout,
    # GP alphas, dequantisation), in bf16: test_fn draws from seed 1 only
    n_dev = cfg.BATCH_SIZE * 10
    dev_x, dev_y = (torch.from_numpy(a[:n_dev]).to(device) for a in flagship.data["test"])
    spread = [float(flagship.trainer.dev_cost(state, dev_x, dev_y, Randomness(seed, device)))
              for seed in DEV_COST_SEEDS]
    launches = dropout_mask.launches, philox_uniform.launches
    n_dev_costs = 2 * len(scores) + len(DEV_COST_SEEDS)
    expected = (6 * n_dev_costs, n_dev_costs) if device.type == "cuda" else (0, 0)
    if launches != expected:
        raise AssertionError(f"dropout_mask, philox_uniform launched {launches} times in the dev costs, "
                             f"expected {expected}")
    grid = decode_png(Path(out_dir) / "samples_24999.png")
    if grid.shape != (320, 320, 3):
        raise AssertionError(f"samples_24999.png is {grid.shape}")
    for precision, score in scores.items():
        full = score["eval"]
        for k, v in JAX_LOGGED.items():
            print(f"jax_checkpoint {precision} {k}: port {full[k]:.5f}, JAX run logged {v}")
        print(f"jax_checkpoint {precision} inception_50k_std: port {full['inception_50k_std']:.5f}; "
              f"test_fn without IS {score['test_s']:.3f} s, with IS over {cfg.inception_samples} and FID "
              f"{score['eval_s']:.3f} s; peak device memory of test_fn without IS above the state "
              f"{score['test_peak_bytes'] / 2**30:.3f} GiB")
        if not all(math.isfinite(full[k]) for k in JAX_LOGGED):
            raise AssertionError(f"non-finite eval in {precision}: {full}")
        if abs(full["inception_50k"] - JAX_LOGGED["inception_50k"]) > IS_GATE:
            raise AssertionError(f"IS {full['inception_50k']} in {precision} is not within {IS_GATE} of "
                                 f"{JAX_LOGGED['inception_50k']}: layouts or loading are wrong")
    print(f"jax_checkpoint dev_cost (bf16) over seeds {list(DEV_COST_SEEDS)}: "
          f"{' '.join(f'{v:.5f}' for v in spread)} (mean {np.mean(spread):.5f}, "
          f"min {min(spread):.5f}, max {max(spread):.5f})")

    serve = {}
    for bf16 in (False, True):
        prefix = str(Path(out_dir) / f"generated_{'bf16' if bf16 else 'fp32'}")
        samples = generate.main(cfg=generate.Config(ckpt=str(ckpt), n=100, out_prefix=prefix, bf16=bf16),
                                device=device)
        if samples.shape != (100, 3072) or not np.isfinite(samples).all() or np.abs(samples).max() > 1:
            raise AssertionError(f"generate (bf16 {bf16}): samples are not finite [100, 3072] values in [-1, 1]")
        if decode_png(prefix + ".png").shape != (320, 320, 3):
            raise AssertionError("generate: the grid does not decode to 320x320 RGB")
        serve["bf16" if bf16 else "fp32"] = generate.main(
            cfg=generate.Config(ckpt=str(ckpt), batch=1024, serve_iters=20, bf16=bf16), device=device)
    if (dropout_mask.launches, philox_uniform.launches) != launches:
        raise AssertionError("generate launched a kernel; G has no dropout and no dequantisation")
    return dict(launches=launches[0], uniform_launches=launches[1], scores=scores, serve=serve,
                dev_cost_spread=spread)


def _d_passes(mode: str) -> int:
    """D passes of a critic substep: real, fake, and for the CT modes the
    CT's second real pass, with a GP the interpolates."""
    return {"wgan-ct": 4, "wgan-CT": 4, "wgan-gp": 3}.get(mode, 2)


def gan_masks_per_iteration(cfg) -> int:
    """An unconditional app's mask launches per iteration (the 64 px "Good"
    ResNet's critic and the MNIST and CIFAR-10 conv critics drop out 3
    times per pass): 3 in the G substep and 3 in each D pass of each critic
    substep."""
    return 3 + (1 if cfg.MODE == "dcgan" else cfg.CRITIC_ITERS) * 3 * _d_passes(cfg.MODE)


def dcgan_masks_per_test(cfg) -> int:
    """Mask launches of one ``test_fn`` of the MNIST or CIFAR-10 app: the
    dev cost's 10 batches of ``BATCH_SIZE``, 3 in each D pass, and for
    CIFAR-10 the slope monitor's one D pass."""
    return 10 * 3 * _d_passes(cfg.MODE) + (3 if isinstance(cfg, cifar_app.Config) else 0)


def _run_gan_main(module, cfg, device) -> tuple:
    """``module.main`` (an unconditional app) with the kernels' launches
    counted from 0, each step timed on the host clock between two
    synchronisations, and stdout kept.  Returns (state, records, mask
    launches, uniform launches, step seconds per iteration, stdout,
    seconds)."""
    make_step_fn, step_s = module.make_step_fn, []
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)

    def timed(*args):
        step = make_step_fn(*args)

        def step_fn(state, rand):
            sync()
            t0 = time.perf_counter()
            out = step(state, rand)
            sync()
            step_s.append(time.perf_counter() - t0)
            return out

        return step_fn

    dropout_mask.launches = philox_uniform.launches = 0
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    module.make_step_fn = timed
    try:
        with contextlib.redirect_stdout(tee):
            state, records = module.main(cfg=cfg, device=device)
    finally:
        module.make_step_fn = make_step_fn
    return (state, records, dropout_mask.launches, philox_uniform.launches, step_s, tee.buf.getvalue(),
            time.perf_counter() - t0)


def _gan_run_report(run: tuple, cfg, start: int, per_iteration: int, device, *, extra_launches: int = 0,
                    metrics=("wgan", "ct", "gp", "disc_cost", "gen_cost")) -> dict:
    """The checks every unconditional app's ``main`` gets
    (``_run_gan_main``'s output ``run``): the resume line, the mask
    launches (``per_iteration`` each plus ``extra_launches`` on the card, no
    uniforms), the end step, ``metrics`` finite in the last record; and its
    timings and peak memory.  Returns them with the final ``state``."""
    state, records, launches, uniforms, step_s, stdout, seconds = run
    if start:
        want = f"resumed from {Path(cfg.out_dir) / 'ckpt' / f'ckpt_{start}.npz'} at iteration {start}"
        if want not in stdout:
            raise AssertionError(f"no line {want!r} in the resumed run's output")
    expected = (cfg.ITERS - start) * per_iteration + extra_launches if device.type == "cuda" else 0
    if (launches, uniforms) != (expected, 0):
        raise AssertionError(f"dropout_mask, philox_uniform launched {launches}, {uniforms} times, "
                             f"expected {expected}, 0")
    if state.step != cfg.ITERS or records[-1]["iteration"] != cfg.ITERS - 1:
        raise AssertionError(f"run ended at step {state.step}, records {records[-1]}")
    last = records[-1]
    for k in metrics:
        if not math.isfinite(last[k]):
            raise AssertionError(f"{k} = {last[k]}")
    first = start + (start == 0 and cfg.ITERS > 1)  # a fresh run's iteration 0 warms cuDNN up
    timed = step_s[first - start:]
    return dict(state=state, launches=launches, uniform_launches=uniforms, per_iteration=per_iteration,
                timed=f"{first}-{cfg.ITERS - 1}", s_per_iter=float(np.mean(timed)),
                s_per_iter_min=float(min(timed)), s_per_iter_all=[round(t, 5) for t in step_s],
                peak_bytes=torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
                seconds=seconds, last=last)


def _check_run_files(cfg, start: int, grid_shape: tuple, extra: tuple = ()) -> None:
    """Checkpoints, logs, ``params_latest.npz`` and each test's grid (of
    ``grid_shape`` pixels) in ``cfg.out_dir``, and ``extra`` files when a
    test ran."""
    out, tests = Path(cfg.out_dir), _test_iterations(cfg, start)
    saves = [n for n in range(start + 1, cfg.ITERS + 1) if n % cfg.save_every == 0]
    files = [f"ckpt/ckpt_{n}.npz" for n in saves] + ["log.pkl", "log.ndjson"]
    files += (["params_latest.npz"] if saves else []) + [f"samples_{it}.png" for it in tests]
    files += list(extra) if tests else []
    missing = [f for f in files if not (out / f).is_file()]
    if missing:
        raise AssertionError(f"missing in out_dir: {missing}")
    for it in tests:
        if decode_png(out / f"samples_{it}.png").shape != grid_shape:
            raise AssertionError(f"samples_{it}.png is not a grid of {grid_shape} pixels")


def _check_samples(samples: torch.Tensor, cfg, device, shape: tuple, low: float) -> None:
    """G's samples: ``shape``, bf16 where the run was (``cfg.BF16`` on the
    card), finite and in ``[low, 1]``."""
    want_dtype = torch.bfloat16 if cfg.BF16 and device.type == "cuda" else torch.float32
    if samples.dtype != want_dtype or samples.shape != shape:
        raise AssertionError(f"generator samples are {samples.dtype} {tuple(samples.shape)}")
    if not bool(torch.isfinite(samples).all()) or samples.min() < low or samples.max() > 1:
        raise AssertionError(f"generator samples are not finite values in [{low}, 1]")


def phase_train64(device, cfg: app64.Config, start: int = 0) -> dict:
    """One ``app64.main`` in ``cfg.out_dir`` (fresh, or resuming at
    ``start``): launches (``gan_masks_per_iteration`` each, none of the
    uniform kernel: no dequantisation on this path), files, grids, finite
    metrics, IS/FID in range, G's samples; seconds per step over iterations
    1-9 (synchronised) and peak device memory."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run = _run_gan_main(app64, cfg, device)
    out = _gan_run_report(run, cfg, start, gan_masks_per_iteration(cfg), device)
    state, records, stdout = out.pop("state"), run[1], run[5]
    _check_run_files(cfg, start, (512, 512, 3))
    evals = [{k: r[k] for k in ("iteration", "inception score", "fid")} for r in records if "inception score" in r]
    for r in evals:
        if not (math.isfinite(r["fid"]) and 1.0 <= r["inception score"] <= 10.0):
            raise AssertionError(f"IS/FID out of range: {r}")
    with torch.no_grad():
        samples = good64.generator(state.gen_params, 64, Randomness(1, device), dim=cfg.DIM)
    _check_samples(samples, cfg, device, (64, 3 * 64 * 64), -1.0)
    fit = re.search(r"IS scorer: fitted in ([0-9.]+) s", stdout)
    return out | dict(evals=evals, scorer_fit_s=float(fit.group(1)) if fit else None)


def phase_resume_equal_gan(device, *, precision="float32", dim=16, batch=4, n_critic=2, iters=4,
                           seed=0) -> float:
    """``phase_resume_equal`` for the 64 px app's step (``app64.make_step_fn``:
    the pool batch, scaling and flips, then ``GanTrainer.step``) at
    ``dim``: ``iters`` iterations uninterrupted against ``iters // 2``, a
    checkpoint written and read back into a fresh app, and the rest, cuDNN
    deterministic.  Returns the largest param difference, which must be 0."""
    device = torch.device(device)
    data = np.random.default_rng(seed)
    pool = (data.integers(0, 256, (64, 3 * 64 * 64), dtype=np.uint8), data.integers(0, 10, 64))
    cfg = app64.Config(DIM=dim, BATCH_SIZE=batch, CRITIC_ITERS=n_critic, BF16=False, seed=seed)

    def run(run_app, state, start, stop):
        step_fn = app64.make_step_fn(run_app)
        for _ in range(start, stop):
            step_fn(state, run_app.rand)

    with precision_policy(precision):
        old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            whole = app64.setup(cfg, device, pool)
            run(whole, whole.state, 0, iters)
            first = app64.setup(cfg, device, pool)
            run(first, first.state, 0, iters // 2)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_resume64_") as tmp:
                path = save_checkpoint(os.path.join(tmp, "ckpt.npz"), {"state": state_to_jax(first.state)})
                second = app64.setup(cfg, device, pool)
                resumed = state_from_jax(load_checkpoint(path)["state"], device, GanState)
            run(second, resumed, iters // 2, iters)
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old
    got, want = state_to_jax(resumed), state_to_jax(whole.state)
    diff = max(float(np.abs(got[f][k] - want[f][k]).max()) for f in ("gen_params", "disc_params")
               for k in want[f])
    print(f"resume_equal_gan on {device} in {precision}: {iters // 2} + checkpoint + "
          f"{iters - iters // 2} iterations vs {iters}: max param diff {diff:.3g}")
    if diff != 0 or not int(got["step"]) == int(want["step"]) == iters:
        raise AssertionError(f"resumed 64 px run differs from the uninterrupted one by {diff}")
    return diff


def _good64_images(gen: dict, noise: np.ndarray, device, batch: int = 100) -> torch.Tensor:
    """G's flat images of ``noise`` in batches of ``batch`` (batch
    statistics), under the precision policy in force."""
    with torch.no_grad():
        return torch.cat([good64.generator(gen, batch, None, noise=torch.from_numpy(noise[i:i + batch]).to(device))
                          for i in range(0, len(noise), batch)])


def phase_good64_checkpoint(device, out_dir: str) -> dict:
    """The JAX run's 64 px checkpoint (``runs/good64_r5/params_latest.npz``,
    iteration 13000) through the bridge, in fp32 and bf16: 1,000 images of
    ``default_rng(0)`` noise in batches of 100, IS with the committed
    ``scorer.npz`` (under the same precision) and FID against the pool's
    first 1,000, gated against ``GOOD64_IS_REF``; the first 100 fp32 images
    against the port's CPU G; then ``apps.generate --model good64``: a
    grid, and batch 1024 served in fp32 and with ``--bf16``."""
    device = torch.device(device)
    params, scorer_path = GOOD64_RUN / "params_latest.npz", GOOD64_RUN / "scorer.npz"
    for path in (params, scorer_path):
        print(f"sha256 {path.relative_to(ROOT)} {_sha256(path)}")
    blob = load_checkpoint(str(params))
    if blob["iteration"] != 13000:
        raise AssertionError(f"unexpected iteration {blob['iteration']}")
    fresh = good64.init_params(64)
    for field, prefix in (("gen_params", "Generator"), ("disc_params", "Discriminator")):
        got = {k: v.shape for k, v in blob["params"][field].items()}
        if got != {k: v.shape for k, v in fresh.items() if k.startswith(prefix)}:
            raise AssertionError(f"{field} of the JAX checkpoint do not match the port's model")
    gen_cpu = from_jax_params(blob["params"]["gen_params"])
    gen = {k: v.to(device) for k, v in gen_cpu.items()}
    noise = np.random.default_rng(0).standard_normal((1000, 128), dtype=np.float32)
    scorer = TrainedScorer(3, 64, cache_path=str(scorer_path), device=device)
    real = synthetic_images(4096, 3, 64, seed=0)[0][:1000]
    dropout_mask.launches = philox_uniform.launches = 0
    scores, images = {}, {}
    for precision, gate in (("float32", GOOD64_IS_GATE_FP32), ("bfloat16", GOOD64_IS_GATE_BF16)):
        with precision_policy(precision):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flat = _good64_images(gen, noise, device)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            fakes = ((flat.float() + 1.0) * (255.0 / 2)).to(torch.int32)
            is_mean, is_std = scorer.inception_score(fakes)
            fid = scorer.fid(real, fakes)
        images[precision] = flat
        scores[precision] = dict(inception_score=is_mean, inception_std=is_std, fid=fid, generate_s=gen_s)
        print(f"good64_checkpoint {precision}: IS {is_mean:.5f} (std {is_std:.5f}), FID {fid:.5f}; "
              f"IS_ref {GOOD64_IS_REF:.5f} (JAX, fp32, CPU), JAX run logged {GOOD64_LOGGED_IS} at iteration "
              f"11999; 1,000 images generated in {gen_s:.3f} s")
        if not (math.isfinite(is_mean) and math.isfinite(fid)):
            raise AssertionError(f"non-finite scores in {precision}: {scores[precision]}")
        if abs(is_mean - GOOD64_IS_REF) > gate:
            raise AssertionError(f"IS {is_mean} in {precision} is not within {gate} of the JAX package's "
                                 f"{GOOD64_IS_REF}")
        if abs(is_mean - GOOD64_LOGGED_IS) > GOOD64_LAYOUT_GATE:
            raise AssertionError(f"IS {is_mean} in {precision} is not within {GOOD64_LAYOUT_GATE} of the "
                                 f"logged {GOOD64_LOGGED_IS}: layouts or loading are wrong")
    with precision_policy("float32"):
        cpu = _good64_images(gen_cpu, noise[:100], "cpu")
    cpu_diff = float((images["float32"][:100].cpu() - cpu).abs().max())
    print(f"good64_checkpoint: the first 100 fp32 images on {device} (TF32 convs) vs the CPU: max abs diff "
          f"{cpu_diff:.3g} (bound {GOOD64_CPU_BOUND})")
    if cpu_diff > GOOD64_CPU_BOUND:
        raise AssertionError(f"fp32 G on {device} differs from the CPU's by {cpu_diff}")

    prefix = str(Path(out_dir) / "generated_good64")
    samples = generate.main(cfg=generate.Config(model="good64", ckpt=str(params), n=100, out_prefix=prefix),
                            device=device)
    if samples.shape != (100, 3 * 64 * 64) or not np.isfinite(samples).all() or np.abs(samples).max() > 1:
        raise AssertionError("generate good64: samples are not finite [100, 12288] values in [-1, 1]")
    if decode_png(prefix + ".png").shape != (640, 640, 3):
        raise AssertionError("generate good64: the grid does not decode to 640x640 RGB")
    serve = {("bf16" if bf16 else "fp32"): generate.main(
        cfg=generate.Config(model="good64", ckpt=str(params), batch=1024, serve_iters=20, bf16=bf16),
        device=device) for bf16 in (False, True)}
    if (dropout_mask.launches, philox_uniform.launches) != (0, 0):
        raise AssertionError("the 64 px G launched a kernel; it has no dropout and no dequantisation")
    return dict(scores=scores, cpu_diff=cpu_diff, serve=serve)


def _dcgan_chw(cfg) -> tuple[int, int, int]:
    return (1, 28, 28) if isinstance(cfg, mnist_app.Config) else (3, 32, 32)


def _grid_shape(n: int, chw) -> tuple:
    """The pixels' shape of ``save_sample_grid``'s grid of ``n`` images."""
    return make_grid(np.zeros((n, *chw) if chw[0] == 3 else (n, *chw[1:]))).shape


def phase_train_dcgan(device, module, cfg, start: int = 0) -> dict:
    """One ``main`` of the MNIST or CIFAR-10 app (``module``) in
    ``cfg.out_dir`` (fresh, or resuming at ``start``): launches
    (``gan_masks_per_iteration`` per iteration and ``dcgan_masks_per_test``
    per ``test_fn``; no dequantisation draws), files (checkpoints, logs,
    grids, CIFAR-10's ``disc_params.npz``), the grids decoded, finite
    metrics and dev costs, CIFAR-10's ``slope_real`` and IS, G's samples
    in its range; seconds per step (synchronised) and peak device memory."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    is_cifar = isinstance(cfg, cifar_app.Config)
    tests = _test_iterations(cfg, start)
    run = _run_gan_main(module, cfg, device)
    keys = ("wgan", "ct", "gp", "disc_cost", "gen_cost") if cfg.MODE == "wgan-CT" else ("disc_cost", "gen_cost")
    out = _gan_run_report(run, cfg, start, gan_masks_per_iteration(cfg), device,
                          extra_launches=len(tests) * dcgan_masks_per_test(cfg), metrics=keys)
    state, records, stdout = out.pop("state"), run[1], run[5]
    chw = _dcgan_chw(cfg)
    _check_run_files(cfg, start, _grid_shape(mnist_app.N_GRID, chw), ("disc_params.npz",) if is_cifar else ())
    tested = [r for r in records if r["iteration"] in tests]
    test_keys = ("dev disc cost", "slope_real") if is_cifar else ("dev disc cost",)
    for r in tested:
        for k in test_keys:
            if not math.isfinite(r[k]):
                raise AssertionError(f"iteration {r['iteration']}: {k} = {r[k]}")
    evals = [{k: r[k] for k in ("iteration", "inception score")} for r in records if "inception score" in r]
    if any(not 1.0 <= r["inception score"] <= 10.0 for r in evals):
        raise AssertionError(f"IS out of range: {evals}")
    gen = dcgan.cifar_generator if is_cifar else dcgan.mnist_generator
    kw = {} if is_cifar else {"mode": cfg.MODE}
    with torch.no_grad():
        samples = gen(state.gen_params, 64, Randomness(1, device), dim=cfg.DIM, **kw)
    _check_samples(samples, cfg, device, (64, math.prod(chw)), -1.0 if is_cifar else 0.0)
    fit = re.search(r"IS scorer: fitted in ([0-9.]+) s", stdout)
    return out | dict(per_test=dcgan_masks_per_test(cfg), evals=evals,
                      scorer_fit_s=float(fit.group(1)) if fit else None,
                      tests={r["iteration"]: {k: r[k] for k in test_keys} for r in tested})


# The JAX package's MNIST (dim 64) and CIFAR-10 (dim 128) G at seed 0 (JAX's init_context(0), as each
# app builds it) on np.random.default_rng(0).standard_normal((100, 128), dtype=float32), fp32 on the
# CPU, and its wgan-CT D's logits at keep probability 1 on those images: the mean and standard
# deviation of G's [100, C*H*W] output and 8 elements at np.linspace(0, size - 1, 8) of it, the
# logits' mean, standard deviation and first 8.  Recompute with
#   python -m pytest tests/test_torch_chip_dcgan.py -k pinned
DCGAN_REF = {
    "mnist": {"g_mean": 0.49694916125044836, "g_std": 0.04057303857610614,
              "g_at": [0.49881061911582947, 0.4659322500228882, 0.494426965713501, 0.4745745360851288,
                       0.4982982575893402, 0.5139520764350891, 0.49585551023483276, 0.5037436485290527],
              "d_mean": 0.08463087532669306, "d_std": 0.014772644554788507,
              "d_first": [0.11398418247699738, 0.09097158908843994, 0.10741780698299408, 0.09152869135141373,
                          0.12568166851997375, 0.06450556218624115, 0.07299278676509857, 0.07715606689453125]},
    "cifar": {"g_mean": 0.12647169874645414, "g_std": 0.6956567851474413,
              "g_at": [0.11182042956352234, -0.9930117726325989, 0.06737671792507172, -0.5290616154670715,
                       0.9831655621528625, 0.9142425656318665, 0.9843605160713196, -0.02610231749713421],
              "d_mean": 0.3234027359634638, "d_std": 0.23792586357823006,
              "d_first": [-0.12092852592468262, 0.45428597927093506, 0.4194769263267517, 0.4593014121055603,
                          0.3839319944381714, 0.1653478592634201, 0.24291810393333435, 0.3288569152355194]},
}
DCGAN_REF_DIMS = {"mnist": 64, "cifar": 128}
DCGAN_REF_BOUND = 1e-4  # absolute, on every pinned number


def dcgan_ref_summary(images: np.ndarray, logits: np.ndarray) -> dict:
    """The numbers ``DCGAN_REF`` pins, of G's flat images and D's logits."""
    g = np.asarray(images, np.float64).reshape(-1)
    d = np.asarray(logits, np.float64)
    idx = np.linspace(0, g.size - 1, 8).astype(int)
    return {"g_mean": float(g.mean()), "g_std": float(g.std()), "g_at": [float(v) for v in g[idx]],
            "d_mean": float(d.mean()), "d_std": float(d.std()), "d_first": [float(v) for v in d[:8]]}


def dcgan_ref_outputs(arch: str, device) -> dict:
    """``dcgan_ref_summary`` of the port's G and D at seed 0, as
    ``DCGAN_REF`` was made, on ``device``, under the precision in force."""
    dim = DCGAN_REF_DIMS[arch]
    p = {k: v.to(device) for k, v in from_jax_params(dcgan.init_params(arch, dim, "wgan-CT", 0)).items()}
    gen, disc = ((dcgan.mnist_generator, dcgan.mnist_discriminator) if arch == "mnist"
                 else (dcgan.cifar_generator, dcgan.cifar_discriminator))
    noise = torch.from_numpy(np.random.default_rng(0).standard_normal((100, 128), dtype=np.float32)).to(device)
    with torch.no_grad():
        images = gen(p, 100, None, dim=dim, noise=noise)
        logits, _ = disc(p, images, None, dim=dim, keep_prob=1.0)
    return dcgan_ref_summary(images.float().cpu().numpy(), logits.float().cpu().numpy())


def _largest_gap(got: dict, want: dict) -> float:
    return max(abs(a - b) for k in want for a, b in zip(np.atleast_1d(got[k]), np.atleast_1d(want[k]), strict=True))


def phase_dcgan_ref(device) -> dict:
    """The full-width gate that stands in for a JAX checkpoint: the port's
    MNIST and CIFAR-10 G and D at seed 0 on ``device``, in fp32 with TF32
    off, against the JAX package's outputs pinned in ``DCGAN_REF``, every
    number within ``DCGAN_REF_BOUND``.  No kernel is launched (keep 1)."""
    before = dropout_mask.launches
    gaps = {}
    with precision_policy("float32"), _no_tf32():
        for arch in DCGAN_REF:
            gaps[arch] = _largest_gap(dcgan_ref_outputs(arch, device), DCGAN_REF[arch])
            print(f"dcgan_ref {arch} dim {DCGAN_REF_DIMS[arch]}: the port on {device} (fp32, TF32 off) against the "
                  f"JAX package's pinned G and D outputs: largest gap {gaps[arch]:.3g} (bound {DCGAN_REF_BOUND})")
    if dropout_mask.launches != before:
        raise AssertionError("dcgan_ref launched a mask at keep probability 1")
    bad = {k: v for k, v in gaps.items() if not v <= DCGAN_REF_BOUND}
    if bad:
        raise AssertionError(f"dcgan_ref: the port's outputs differ from the JAX package's by {bad}")
    return gaps


# each served model's image shape, value floor, grid size, and the batch and queued requests timed
SERVED = {"mnist": ((1, 28, 28), 0.0, 100, 1024, 20), "cifar": ((3, 32, 32), -1.0, 100, 1024, 20),
          "lsun128": ((3, 128, 128), -1.0, 16, 256, 10)}


def phase_serve_gan(device, ckpts: dict, out_dir: str) -> dict:
    """``apps.generate --model <model>`` on each train phase's
    ``params_latest.npz`` in ``ckpts``: a grid, then a batch served in
    fp32 and with ``--bf16`` (images/s), at ``SERVED``'s sizes; G
    launches no kernel."""
    before = dropout_mask.launches, philox_uniform.launches
    serve = {}
    for model, ckpt in ckpts.items():
        chw, low, n, batch, iters = SERVED[model]
        prefix = str(Path(out_dir) / f"generated_{model}")
        samples = generate.main(cfg=generate.Config(model=model, ckpt=ckpt, n=n, batch=n, out_prefix=prefix),
                                device=device)
        if samples.shape != (n, math.prod(chw)) or not np.isfinite(samples).all() or not (
                low <= samples.min() and samples.max() <= 1):
            raise AssertionError(f"generate {model}: samples are not finite [{n}, {math.prod(chw)}] in [{low}, 1]")
        if decode_png(prefix + ".png").shape != _grid_shape(n, chw):
            raise AssertionError(f"generate {model}: the grid is not {n} images of {chw}")
        for bf16 in (False, True):
            serve[f"{model} {'bf16' if bf16 else 'fp32'}"] = generate.main(
                cfg=generate.Config(model=model, ckpt=ckpt, batch=batch, serve_iters=iters, bf16=bf16), device=device)
    if (dropout_mask.launches, philox_uniform.launches) != before:
        raise AssertionError("generate launched a kernel; G has no dropout")
    return serve


def _train64_line(name: str, out: dict) -> str:
    return (f"{name}: {out['s_per_iter']:.5f} s/iter over iterations {out['timed']} "
            f"(min {out['s_per_iter_min']:.5f}; "
            f"each step synchronised), {out['seconds']:.2f} s for main (scorer fit {out['scorer_fit_s']} s), "
            f"peak {out['peak_bytes'] / 2**30:.3f} GiB, mask launches {out['launches']} "
            f"({out['per_iteration']} per iteration), evals {json.dumps(out['evals'])}, "
            f"last {json.dumps(out['last'])}")


def _train_line(name: str, out: dict) -> str:
    return (f"{name}: {out['s_per_iter']:.5f} s/iter over iterations 1-3, {out['seconds']:.2f} s for main "
            f"(scorer fit {out['scorer_fit_s']} s), peak {out['peak_bytes'] / 2**30:.3f} GiB, "
            f"launches {out['launches']} + {out['uniform_launches']}, evals {json.dumps(out['evals'])}, "
            f"last {json.dumps(out['last'])}")


def _dcgan_line(name: str, out: dict) -> str:
    peak = "not measured" if out["peak_bytes"] is None else f"{out['peak_bytes'] / 2**30:.3f} GiB"
    return (f"{name}: {out['s_per_iter']:.5f} s/iter over iterations {out['timed']} "
            f"(min {out['s_per_iter_min']:.5f}; each step synchronised), {out['seconds']:.2f} s for main, "
            f"peak {peak}, mask launches "
            f"{out['launches']} ({out['per_iteration']} per iteration, {out['per_test']} per test_fn), "
            f"tests {json.dumps(out['tests'])}, evals {json.dumps(out['evals'])}, last {json.dumps(out['last'])}")


def run_dcgan_apps(device, out_dir: str, scorer: Path | None = None) -> dict:
    """The MNIST and CIFAR-10 apps at their defaults (bf16 on the card),
    cut in depth: 10 iterations (test_fn every 5, checkpoints every 5; for
    CIFAR-10 the IS at iteration 9 on its default 1,000 samples, through
    the flagship train phase's fitted ``scorer`` when given), ``main`` again
    to 12 (a resume at 10), and 4 iterations in fp32; then ``generate`` on
    each bf16 run's ``params_latest.npz``."""
    runs, ckpts = {}, {}
    for name, module in (("mnist", mnist_app), ("cifar", cifar_app)):
        extra = {"inception_every": 10} if module is cifar_app else {}
        cfg = module.Config(ITERS=TRAIN_ITERS, save_every=5, sample_every=5, out_dir=f"{out_dir}/{name}", **extra)
        if module is cifar_app and scorer is not None and scorer.is_file():
            os.makedirs(cfg.out_dir, exist_ok=True)
            shutil.copy(scorer, Path(cfg.out_dir) / "scorer.npz")
        print(f"train_{name}: cut for time: ITERS {TRAIN_ITERS} (of {module.Config().ITERS}); DIM {cfg.DIM}, "
              f"BATCH_SIZE {cfg.BATCH_SIZE}, MODE {cfg.MODE}, BF16 {cfg.BF16} (the defaults)")
        runs[f"train_{name}"] = _phase(f"train_{name}", phase_train_dcgan, device, module, cfg)
        runs[f"train_{name}_resume"] = _phase(f"train_{name}_resume", phase_train_dcgan, device, module,
                                              dataclasses.replace(cfg, ITERS=RESUME_ITERS), start=TRAIN_ITERS)
        fp32 = dataclasses.replace(cfg, ITERS=4, BF16=False, save_every=2, sample_every=2,
                                   out_dir=f"{out_dir}/{name}_fp32", **{k: 0 for k in extra})
        runs[f"train_{name}_fp32"] = _phase(f"train_{name}_fp32", phase_train_dcgan, device, module, fp32)
        ckpts[name] = f"{cfg.out_dir}/params_latest.npz"
    serve = _phase("serve_dcgan", phase_serve_gan, device, ckpts, out_dir)
    return {"runs": runs, "serve": serve}


# ---------------------------------------------------------------- 128 px LSUN and the rest of 64 px

# The JAX package's full-width 128 px LSUN G at seed 0 (JAX's init_context(0), as its app builds it) on
# np.random.default_rng(0).standard_normal((16, 128), dtype=float32), fp32 on the CPU, and its D's logits
# at keep probability 1 on those images: the numbers of dcgan_ref_summary.  Recompute with
#   python -m pytest -m slow tests/test_torch_chip_lsun128.py -k pinned
LSUN128_REF = {
    "g_mean": 0.09716434102979599, "g_std": 0.3362391677345411,
    "g_at": [-0.04576167091727257, 0.11142399907112122, -0.3158318102359772, 0.363416463136673,
             -0.12553437054157257, -0.1443500816822052, -0.07247890532016754, -0.14504244923591614],
    "d_mean": -1.5443111583590508, "d_std": 0.16263858717736474,
    "d_first": [-1.6306447982788086, -1.2827105522155762, -1.5009427070617676, -1.8400251865386963,
                -1.736937403678894, -1.5843088626861572, -1.5283321142196655, -1.5957111120224],
}
LSUN128_REF_BOUND = 1e-4  # absolute, on every pinned number, as DCGAN_REF_BOUND
N_LSUN128_REF = 16
TRAIN128_ITERS, RESUME128_ITERS, FP32_128_ITERS = 6, 8, 3
# small widths for the substep comparison with the CPU (the defaults are 1024 at G's 4 px and D's 8 px)
LSUN128_SMALL = lsun128.Lsun128Config(dim_g_4=64, dim_g_8=32, dim_g_16=16, dim_g_32=16, dim_g_64=16,
                                      dim_d_64=16, dim_d_32=16, dim_d_16=32, dim_d_8=64)


def lsun128_mask_shapes(batch: int = 64, cfg: lsun128.Lsun128Config = lsun128.Lsun128Config()) -> list[tuple]:
    """The 128 px critic's one mask shape: after its third down block and
    each 8 px block (keep 0.8, 0.5, 0.5), 21 launches each per iteration."""
    return [(batch, cfg.dim_d_8, 8, 8)]


def lsun128_masks_per_iteration(cfg: app128.Config) -> int:
    """3 masks in the G substep and in each of a critic substep's 4 D
    passes (real, fake, the CT's second real pass, the GP's
    interpolates): 63 at 5 critic iterations."""
    return 3 + cfg.CRITIC_ITERS * 3 * _d_passes("wgan-CT")


def lsun128_ref_outputs(device) -> dict:
    """``dcgan_ref_summary`` of the port's full-width 128 px G and D at seed
    0, as ``LSUN128_REF`` was made, on ``device``, under the precision in
    force."""
    p = {k: v.to(device) for k, v in from_jax_params(lsun128.init_params(seed=0)).items()}
    noise = torch.from_numpy(np.random.default_rng(0).standard_normal((N_LSUN128_REF, 128), dtype=np.float32))
    with torch.no_grad():
        images = lsun128.generator(p, N_LSUN128_REF, None, noise=noise.to(device))
        logits, _ = lsun128.discriminator(p, images, None, kps=(1.0, 1.0, 1.0))
    return dcgan_ref_summary(images.float().cpu().numpy(), logits.float().cpu().numpy())


def phase_lsun128_ref(device) -> float:
    """The full-width gate for the 128 px model, which no JAX checkpoint
    covers: the port's G and D at seed 0 on ``device``, fp32 with TF32 off,
    against the JAX package's outputs pinned in ``LSUN128_REF``, every
    number within ``LSUN128_REF_BOUND``.  No kernel is launched (keep 1)."""
    before = dropout_mask.launches
    with precision_policy("float32"), _no_tf32():
        gap = _largest_gap(lsun128_ref_outputs(device), LSUN128_REF)
    print(f"lsun128_ref: the port's full-width G on {N_LSUN128_REF} images and D at keep 1 on {device} (fp32, "
          f"TF32 off) against the JAX package's pinned outputs: largest gap {gap:.3g} (bound {LSUN128_REF_BOUND})")
    if dropout_mask.launches != before:
        raise AssertionError("lsun128_ref launched a mask at keep probability 1")
    if not gap <= LSUN128_REF_BOUND:
        raise AssertionError(f"lsun128_ref: the port's outputs differ from the JAX package's by {gap}")
    return gap


def phase_cuda_vs_cpu_lsun128(device, *, precision="float32", batch=4, n_critic=2, iters=2, seed=0) -> float:
    """``phase_cuda_vs_cpu_gan`` for the 128 px model at ``LSUN128_SMALL``'s
    widths and the LSUN app's trainer (wgan-CT, Adam with beta1 0 and
    linear decay), batch 4, with its bounds, but for the losses in bf16:
    those are held to ``BF16_GRAD_BOUND`` (32 U) of their value, not 4 U.
    Through this critic's 5 blocks and 10 layer norms two correct bf16 runs
    on the CPU that differ only in the order of one sum (the down blocks'
    shortcut fused into one stride-2 conv or not) give losses up to 4.0%
    apart, and bf16 is up to 4.3% from fp32 (seeds 0-2;
    ``tests/torch_lsun128_bf16_probe.py``).  The gradients keep their
    bounds."""
    gcfg = GanConfig(mode="wgan-CT", batch_size=batch, critic_iters=n_critic, iters=100, beta1=0.0,
                     lr_decay=True)
    trainer = GanTrainer(
        lambda p, n, rand, noise=None: lsun128.generator(p, n, rand, cfg=LSUN128_SMALL, noise=noise),
        lambda p, x, rand: lsun128.discriminator(p, x, rand, cfg=LSUN128_SMALL),
        gcfg,
    )
    bf16 = precision == "bfloat16"
    check, report, failures = _substep_checker(device, bf16=bf16, lr=gcfg.lr, beta1=gcfg.beta1,
                                               zero_grad=lsun128.zero_grad_params(LSUN128_SMALL), elementwise=False,
                                               bf16_loss_bound=BF16_GRAD_BOUND)
    with precision_policy(precision), _no_tf32():
        _lockstep_gan(device, trainer, lsun128.init_params(LSUN128_SMALL, seed), iters=iters, seed=seed,
                      check=check, real_dim=3 * 128 * 128)
    return _lockstep_report(f"lsun128 small, batch {batch}: ", device, precision, iters, report, failures)


def phase_train128(device, cfg: app128.Config, start: int = 0) -> dict:
    """One ``app128.main`` in ``cfg.out_dir`` (fresh, or resuming at
    ``start``): 63 mask launches per iteration at the defaults, files
    (checkpoints, logs, 8 x 8 grids of 128 px), finite metrics, G's samples
    in [-1, 1] in the run's dtype; seconds per step (synchronised) and peak
    device memory."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = _gan_run_report(_run_gan_main(app128, cfg, device), cfg, start, lsun128_masks_per_iteration(cfg), device)
    state = out.pop("state")
    _check_run_files(cfg, start, _grid_shape(app128.N_GRID, app128.CHW))
    with torch.no_grad():
        samples = lsun128.generator(state.gen_params, 16, Randomness(1, device), cfg=app128.model_config(cfg))
    _check_samples(samples, cfg, device, (16, 3 * 128 * 128), -1.0)
    return out


def phase_train64_more(device, cfg: app64.Config) -> dict:
    """``app64.main`` on a path the ``train64`` phase does not take: ``ARCH
    resnet101`` (no dropout in D, so no mask launch) or ``input native``
    (the native pipeline, which must have built: the app's directory path
    would pass silently otherwise); launches, end step, finite metrics."""
    device = torch.device(device)
    if cfg.input == "native" and not native.native_available():
        raise AssertionError(f"the native library did not build: {native.build_error()}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    per_iteration = 0 if cfg.ARCH == "resnet101" else gan_masks_per_iteration(cfg)
    out = _gan_run_report(_run_gan_main(app64, cfg, device), cfg, 0, per_iteration, device)
    out.pop("state")
    return out


def _gan_line(name: str, out: dict) -> str:
    peak = "not measured" if out["peak_bytes"] is None else f"{out['peak_bytes'] / 2**30:.3f} GiB"
    return (f"{name}: {out['s_per_iter']:.5f} s/iter over iterations {out['timed']} "
            f"(min {out['s_per_iter_min']:.5f}; each step synchronised; all {out['s_per_iter_all']}), "
            f"{out['seconds']:.2f} s for main, peak {peak}, mask launches {out['launches']} "
            f"({out['per_iteration']} per iteration), last {json.dumps(out['last'])}")


def run_lsun128_apps(device, out_dir: str) -> dict:
    """The 128 px app at its defaults (full width, batch 64, bf16), cut in
    depth: ``TRAIN128_ITERS`` iterations with a grid and a checkpoint at 5,
    ``main`` again to ``RESUME128_ITERS`` (a resume from ``ckpt_5``), and
    ``FP32_128_ITERS`` in fp32; ``input dir`` without ``DATA_DIR`` (the
    image-directory reader's synthetic fallback) for 2; ``generate --model
    lsun128`` on the bf16 run's ``params_latest.npz``; then the 64 px app's
    ``ARCH resnet101`` for 3 iterations and ``input native`` for 2."""
    runs = {}
    cfg = app128.Config(ITERS=TRAIN128_ITERS, save_every=5, sample_every=5, out_dir=f"{out_dir}/lsun128")
    print(f"train128: cut for time: ITERS {TRAIN128_ITERS} (of {app128.Config().ITERS}); DIM_G_4 {cfg.DIM_G_4}, "
          f"DIM_D_8 {cfg.DIM_D_8}, BATCH_SIZE {cfg.BATCH_SIZE}, CRITIC_ITERS {cfg.CRITIC_ITERS}, BF16 {cfg.BF16} "
          f"(the defaults)")
    runs["train128"] = _phase("train128", phase_train128, device, cfg)
    runs["train128_resume"] = _phase("train128_resume", phase_train128, device,
                                     dataclasses.replace(cfg, ITERS=RESUME128_ITERS),
                                     start=TRAIN128_ITERS // cfg.save_every * cfg.save_every)
    runs["train128_fp32"] = _phase("train128_fp32", phase_train128, device, dataclasses.replace(
        cfg, ITERS=FP32_128_ITERS, BF16=False, save_every=FP32_128_ITERS, sample_every=FP32_128_ITERS,
        out_dir=f"{out_dir}/lsun128_fp32"))
    runs["train128_dir"] = _phase("train128_dir", phase_train128, device, dataclasses.replace(
        cfg, ITERS=2, input="dir", save_every=2, sample_every=2, out_dir=f"{out_dir}/lsun128_dir"))
    serve = _phase("serve_lsun128", phase_serve_gan, device, {"lsun128": f"{cfg.out_dir}/params_latest.npz"},
                   out_dir)
    for name, kw in (("train64_resnet101", dict(ARCH="resnet101", ITERS=3)), ("train64_native", dict(
            input="native", ITERS=2))):
        cfg64 = app64.Config(save_every=kw["ITERS"], sample_every=kw["ITERS"], inception_every=0,
                             out_dir=f"{out_dir}/{name}", **kw)
        runs[name] = _phase(name, phase_train64_more, device, cfg64)
    return {"runs": runs, "serve": serve}


# ---------------------------------------------------------------- semi-supervised classifiers

SSL_ARCH = {"mnist": "mnist", "cifar": "cifar", "te": "cifar"}
SSL_BATCH = 100
SSL_WARMUP_STEPS = 5  # left out of s/step: cuDNN and the allocator warm up
# The JAX package's deterministic logits of the JAX runs' classifiers on the first 16 synthetic test
# images (CIFAR-10: runs/ssl_te_r5/avg_params.npz; MNIST: runs/ssl_mnist_full/disc_params.npz), fp32 on
# the CPU: their mean and standard deviation, 8 elements at np.linspace(0, size - 1, 8) of the flat
# [16, 10] logits, their largest magnitude and each image's argmax.  Recompute with
#   python -m pytest tests/test_torch_chip_ssl.py -k pinned
SSL_REF = {
    "cifar": {"mean": -16.697296666353942, "std": 12.41567925434824,
              "at": [-24.759723663330078, -7.057608604431152, -23.34950065612793, -20.657615661621094,
                     -21.361427307128906, -25.322324752807617, -22.051618576049805, -17.97441864013672],
              "scale": 47.56877136230469, "argmax": [7, 5, 5, 1, 8, 8, 4, 6, 0, 9, 4, 4, 2, 5, 9, 6]},
    "mnist": {"mean": -44.487477131187916, "std": 46.661352960935496,
              "at": [-102.5860366821289, 33.49204635620117, -18.651689529418945, 27.763343811035156,
                     -96.77287292480469, -110.4996566772461, -42.83403778076172, -9.382884979248047],
              "scale": 189.65830993652344, "argmax": [6, 6, 2, 9, 6, 2, 8, 1, 7, 6, 3, 6, 9, 1, 9, 7]},
}
SSL_REF_PARAMS = {"cifar": ROOT / "runs" / "ssl_te_r5" / "avg_params.npz",
                  "mnist": ROOT / "runs" / "ssl_mnist_full" / "disc_params.npz"}
# Each pinned number within 1e-4 in absolute terms, the gate DCGAN_REF applies.
SSL_REF_BOUND = 1e-4
SSL_LOGGED_TEST_ERR = 0.0  # the last test_err both JAX runs logged (log.pkl; epochs 1000 and 244)
SSL_LOADING_GATE = 0.01    # a wrong layout or a wrong file scores about 0.9


def _ssl_nets(arch: str):
    if arch == "mnist":
        return classifiers.mnist_ssl_classifier, classifiers.mnist_ssl_generator
    return classifiers.cifar_ssl_classifier, classifiers.cifar_ssl_generator


def _ssl_trainer(variant: str):
    """The trainer at the app's defaults (lr, CT weight) of ``variant``."""
    arch = SSL_ARCH[variant]
    cfg = mnist_ssl_app.Config() if arch == "mnist" else cifar_ssl_app.Config()
    return make_ssl_trainer(*_ssl_nets(arch), SslConfig(variant=variant, lr=cfg.learning_rate, lambda_2=cfg.LAMBDA_2))


def _ssl_inputs(variant: str, batch: int, seed: int):
    """A step's seeded inputs: labelled, unlabelled and second unlabelled
    batches in the app's range, labels, and for ``te`` targets."""
    data = np.random.default_rng(seed)
    shape, low = ((784,), 0.0) if variant == "mnist" else ((3, 32, 32), -0.5)
    x = lambda: torch.from_numpy(data.uniform(low, low + 1.0, (batch, *shape)).astype(np.float32))
    x_lab, labels, x_unl, x_unl2 = x(), torch.from_numpy(data.integers(0, 10, batch)), x(), x()
    targets = None
    if variant == "te":
        targets = (torch.softmax(torch.from_numpy(data.normal(size=(batch, 10)).astype(np.float32)), 1),
                   torch.from_numpy(data.normal(0.0, 0.1, (batch, ssl_common.TE_FEATURES)).astype(np.float32)))
    return x_lab, labels, x_unl, x_unl2, targets


def phase_cuda_vs_cpu_ssl(device, *, variant: str = "cifar", batch: int = 4, seed: int = 0) -> dict:
    """One semi-supervised step at full width on ``device`` and on the CPU
    from the same fresh state (``classifiers.init_params``) with the same
    inputs and draws, fp32 with TF32 off: each metric to rtol 1e-3, and for
    D and G the gradient (AdamTheano's first moment at t = 1 holds it:
    ``m / (1 - mom1)``) within ``FP32_GRAD_BOUND`` of the CPU gradient's L1
    mass, the elements stepping the other way carrying at most
    ``FP32_FLIP_BOUND`` of it.  Returns the largest shares and param diff."""
    trainer = _ssl_trainer(variant)
    params = from_jax_params(classifiers.init_params(SSL_ARCH[variant], seed))
    inputs = _ssl_inputs(variant, batch, seed)

    def run(dev):
        disc, gen, _ = split_params({k: v.to(dev, copy=True) for k, v in params.items()}, "Classifier", "Generator")
        state = trainer.init_state(disc, gen)
        x_lab, labels, x_unl, x_unl2, targets = (
            None if t is None else tuple(a.to(dev) for a in t) if isinstance(t, tuple) else t.to(dev) for t in inputs)
        metrics, _, _ = trainer.step(state, x_lab, labels, x_unl, x_unl2, targets, Randomness(seed, dev))
        return state, metrics

    with precision_policy("float32"), _no_tf32():
        dev_state, got = run(device)
        cpu_state, want = run("cpu")
    failures, report = [], {"diff": 0.0}
    for k, w in want.items():
        if not math.isclose(float(got[k]), float(w), rel_tol=1e-3, abs_tol=1e-5):
            failures.append(f"{k} {float(got[k])} on {device} vs {float(w)} on cpu")
    mom1 = trainer.cfg.mom1
    for net, field, opt in (("D", "disc_params", "disc_opt"), ("G", "gen_params", "gen_opt")):
        mass = grad_l1 = flipped = 0.0
        for k, start in params.items():
            if k not in getattr(cpu_state, field):
                continue
            g_dev = getattr(dev_state, opt)["m"][k].double().cpu().numpy() / (1 - mom1)
            g_cpu = getattr(cpu_state, opt)["m"][k].double().numpy() / (1 - mom1)
            p_dev = getattr(dev_state, field)[k].detach().cpu().numpy()
            p_cpu = getattr(cpu_state, field)[k].detach().numpy()
            report["diff"] = max(report["diff"], float(np.abs(p_dev - p_cpu).max()))
            other_way = np.sign(p_dev - start.numpy()) != np.sign(p_cpu - start.numpy())
            mass += float(np.abs(g_cpu).sum())
            grad_l1 += float(np.abs(g_dev - g_cpu).sum())
            flipped += float(np.abs(g_cpu[other_way]).sum())
        report[f"{net}_grad_l1"], report[f"{net}_flipped_mass"] = grad_l1 / mass, flipped / mass
        if grad_l1 > FP32_GRAD_BOUND * mass:
            failures.append(f"{net}: gradients {grad_l1 / mass:.3g} of the CPU's L1 mass apart (> {FP32_GRAD_BOUND})")
        if flipped > FP32_FLIP_BOUND * mass:
            failures.append(f"{net}: elements carrying {flipped / mass:.3g} of the gradient's mass stepped the other "
                            f"way (> {FP32_FLIP_BOUND})")
    line = (f"ssl {variant} batch {batch}: {device} vs cpu in fp32 (TF32 off), one step: max param diff "
            f"{report['diff']:.3g}; gradients apart by {report['D_grad_l1']:.3g} (D) and {report['G_grad_l1']:.3g} (G) "
            f"of the CPU's L1 mass, {report['D_flipped_mass']:.3g} and {report['G_flipped_mass']:.3g} stepping the "
            f"other way; losses {json.dumps({k: float(v) for k, v in got.items()})}")
    print(line)
    if failures:
        raise AssertionError(f"{line}\n" + "\n".join(failures))
    return report


def ssl_test_set(arch: str) -> tuple[np.ndarray, np.ndarray]:
    """The synthetic test split as the app reads it: MNIST flat in [0, 1],
    CIFAR-10 NCHW in [-0.5, 0.5]."""
    if arch == "mnist":
        return mnist.load_arrays()["test"]
    return cifar10.load_normalized(None, "test")


def ssl_ref_summary(logits: np.ndarray) -> dict:
    """The numbers ``SSL_REF`` pins, of ``[16, 10]`` logits."""
    flat = np.asarray(logits, np.float64).reshape(-1)
    idx = np.linspace(0, flat.size - 1, 8).astype(int)
    return {"mean": float(flat.mean()), "std": float(flat.std()), "at": [float(v) for v in flat[idx]],
            "scale": float(np.abs(flat).max()), "argmax": [int(v) for v in np.asarray(logits).argmax(1)]}


def _ssl_ref_params(arch: str, device) -> dict:
    return {k: v.to(device) for k, v in from_jax_params(load_checkpoint(str(SSL_REF_PARAMS[arch]))).items()}


def ssl_ref_outputs(arch: str, device) -> dict:
    """``ssl_ref_summary`` of the port's deterministic logits of the JAX
    run's classifier on the first 16 test images, under the precision in
    force."""
    x = torch.from_numpy(ssl_test_set(arch)[0][:16]).to(device)
    with torch.no_grad():
        params = classifiers.with_applied_weights(_ssl_ref_params(arch, device))
        logits = _ssl_nets(arch)[0](params, x, None, deterministic=True).logits
    return ssl_ref_summary(logits.float().cpu().numpy())


def ssl_ref_gap(got: dict, want: dict) -> float:
    """The largest absolute gap of the pinned numbers; inf if an argmax
    differs."""
    if got["argmax"] != want["argmax"]:
        return math.inf
    return _largest_gap({k: got[k] for k in ("mean", "std", "at")},
                        {k: want[k] for k in ("mean", "std", "at")})


def phase_ssl_ref(device, n_test: int | None = None) -> dict:
    """The JAX runs' classifiers on the card: the pinned logits (fp32, TF32
    off) within ``SSL_REF_BOUND``, argmax equal; then, as the
    app runs (TF32 convs), the trainer's ``test_error`` with those params as
    the averaged ones over the whole synthetic test set, in batches of 100,
    beside the JAX runs' last logged ``test_err``: a loading gate.  No mask
    is drawn.  ``n_test`` cuts the test set (a CPU rehearsal)."""
    before = dropout_mask.launches
    out = {}
    for arch in SSL_REF:
        sha = _sha256(SSL_REF_PARAMS[arch])
        with precision_policy("float32"), _no_tf32():
            gap = ssl_ref_gap(ssl_ref_outputs(arch, device), SSL_REF[arch])
        x, y = (torch.from_numpy(a[:n_test]).to(device) for a in ssl_test_set(arch))
        state = SslState({}, {}, {}, {}, _ssl_ref_params(arch, device))
        trainer = _ssl_trainer(arch)
        with precision_policy("float32"):
            errs = [trainer.test_error(state, x[i:i + SSL_BATCH], y[i:i + SSL_BATCH])
                    for i in range(0, len(x) - SSL_BATCH + 1, SSL_BATCH)]
        err = float(torch.stack(errs).mean())
        out[arch] = {"gap": gap, "test_err": err, "sha256": sha}
        print(f"ssl_ref {arch}: {SSL_REF_PARAMS[arch].relative_to(ROOT)} (sha256 {sha}) on {device}: pinned logits "
              f"(fp32, TF32 off) within {gap:.3g} of the JAX package's (largest magnitude {SSL_REF[arch]['scale']:.2f}) "
              f"(bound {SSL_REF_BOUND}), argmax equal; test error over {len(y)} synthetic test images {err:.5f} "
              f"(loading gate {SSL_LOADING_GATE}; the JAX run logged {SSL_LOGGED_TEST_ERR})")
        if not gap <= SSL_REF_BOUND:
            raise AssertionError(f"ssl_ref {arch}: the port's logits differ from the JAX package's by {gap}")
        if not err <= SSL_LOADING_GATE:
            raise AssertionError(f"ssl_ref {arch}: test error {err} with the JAX run's params: loading is wrong")
    if dropout_mask.launches != before:
        raise AssertionError("ssl_ref drew a mask in a deterministic pass")
    return out


def _run_ssl_main(module, cfg, device) -> tuple:
    """``module.main`` (a semi-supervised app) with each step timed between
    two synchronisations and its mask launches counted, stdout kept.
    Returns (state, records, mask launches of the run, per-step launches,
    step seconds, seconds from the first step to the last epoch's record,
    stdout, seconds)."""
    make_step_fn, step_s, per_step, first = ssl_common.make_step_fn, [], [], []
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)

    def timed(ssl_app):
        step = make_step_fn(ssl_app)

        def step_fn(*args):
            sync()
            if not first:
                first.append(time.time())  # the records' wall clock
            before, t0 = dropout_mask.launches, time.perf_counter()
            out = step(*args)
            sync()
            step_s.append(time.perf_counter() - t0)
            per_step.append(dropout_mask.launches - before)
            return out

        return step_fn

    dropout_mask.launches = philox_uniform.launches = 0
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    ssl_common.make_step_fn = timed
    try:
        with contextlib.redirect_stdout(tee):
            state, records = module.main(cfg=cfg, device=device)
    finally:
        ssl_common.make_step_fn = make_step_fn
    epochs_s = records[-1]["wall_time"] - first[0] if first else 0.0
    return (state, records, dropout_mask.launches, per_step, step_s, epochs_s, tee.buf.getvalue(),
            time.perf_counter() - t0)


def phase_train_ssl(device, module, cfg, *, start: int = 0) -> dict:
    """One ``main`` of a semi-supervised app in ``cfg.out_dir`` (fresh, or
    resuming at epoch ``start``): the resume line, every step's mask
    launches (``ssl_masks_per_step``) and the run's (3 more at a fresh or
    resumed run's data-dependent init, batch 500), the files, one record
    per epoch with finite metrics and a test error, the state's step and
    epoch; s/step over the steps after ``SSL_WARMUP_STEPS`` (synchronised),
    s/epoch, peak device memory."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    is_mnist = isinstance(cfg, mnist_ssl_app.Config)
    variant = "mnist" if is_mnist else "te" if cfg.temporal_ensembling else "cifar"
    state, records, launches, per_step, step_s, epochs_s, stdout, seconds = _run_ssl_main(module, cfg, device)
    out = Path(cfg.out_dir)
    if start:
        want = f"resumed from {out / 'ssl_state.npz'} at epoch {start}"
        if want not in stdout:
            raise AssertionError(f"no line {want!r} in the resumed run's output")
    per = ssl_masks_per_step(variant) if device.type == "cuda" else 0
    init = 3 if per else 0
    steps_per_epoch = len(per_step) // max(cfg.epochs - start, 1)
    if set(per_step) - {per} or launches != len(per_step) * per + init:
        raise AssertionError(f"mask launches {launches} ({sorted(set(per_step))} per step), expected {per} per step "
                             f"and {init} at the init")
    files = ["disc_params.npz", "gen_params.npz", "avg_params.npz", "ssl_state.npz", "log.pkl", "log.ndjson"]
    missing = [f for f in files if not (out / f).is_file()]
    if missing:
        raise AssertionError(f"missing in out_dir: {missing}")
    saved = load_checkpoint(str(out / "ssl_state.npz"))
    n_steps = cfg.epochs * steps_per_epoch
    if int(saved["epoch"]) != cfg.epochs - 1 or state.step != n_steps or int(saved["state"]["step"]) != n_steps:
        raise AssertionError(f"run ended at step {state.step}, saved epoch {saved['epoch']}")
    if [r["iteration"] for r in records] != list(range(start + 1, cfg.epochs + 1)):
        raise AssertionError(f"records of epochs {[r['iteration'] for r in records]}")
    for r in records:
        if not all(math.isfinite(v) for k, v in r.items() if k != "iteration") or not 0 <= r["test_err"] <= 1:
            raise AssertionError(f"epoch {r['iteration']}: {r}")
    timed = step_s[SSL_WARMUP_STEPS:] if start == 0 and len(step_s) > SSL_WARMUP_STEPS else step_s
    return dict(launches=launches, uniform_launches=0, per_step=per, steps=len(per_step),
                s_per_step=float(np.mean(timed)), s_per_step_min=float(min(timed)),
                s_per_epoch=epochs_s / max(cfg.epochs - start, 1), test_err=records[-1]["test_err"],
                peak_bytes=torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
                seconds=seconds, last=records[-1])


def phase_resume_equal_ssl(device, resumed_dir: str, cfg) -> float:
    """``main`` of the MNIST app for ``cfg.epochs`` straight in a fresh
    directory, against the run in ``resumed_dir`` that stopped after one
    epoch and resumed: every array of the two ``ssl_state.npz`` states must
    be equal.  Returns the largest difference."""
    mnist_ssl_app.main(cfg=cfg, device=device)
    got = load_checkpoint(str(Path(resumed_dir) / "ssl_state.npz"))
    want = load_checkpoint(str(Path(cfg.out_dir) / "ssl_state.npz"))
    leaves = lambda tree: ([a for v in tree.values() for a in leaves(v)] if isinstance(tree, dict)
                           else [np.asarray(tree, np.float64)])
    got_leaves, want_leaves = leaves(got["state"]), leaves(want["state"])
    if len(got_leaves) != len(want_leaves) or got["epoch"] != want["epoch"]:
        raise AssertionError("the resumed and the uninterrupted states differ in structure")
    diff = max(float(np.abs(a - b).max()) if a.size else 0.0 for a, b in zip(got_leaves, want_leaves))
    print(f"resume_equal_ssl on {device}: MNIST at full width, 1 + resume to {cfg.epochs} epochs vs {cfg.epochs} "
          f"straight: max diff {diff:.3g} over {len(want_leaves)} arrays (params, averages, Adam moments, t, step)")
    if diff != 0:
        raise AssertionError(f"resumed SSL run differs from the uninterrupted one by {diff}")
    return diff


@contextlib.contextmanager
def _cudnn_deterministic():
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old


def _ssl_line(name: str, out: dict) -> str:
    peak = "not measured" if out["peak_bytes"] is None else f"{out['peak_bytes'] / 2**30:.3f} GiB"
    return (f"{name}: {out['s_per_step']:.5f} s/step (min {out['s_per_step_min']:.5f}; each step synchronised), "
            f"{out['s_per_epoch']:.3f} s/epoch ({out['steps']} steps), {out['seconds']:.2f} s for main, peak {peak}, "
            f"mask launches {out['launches']} ({out['per_step']} per step), test_err {out['test_err']:.5f}, "
            f"last {json.dumps(out['last'])}")


def run_ssl_apps(device, out_dir: str, *, cifar_resume: bool = False) -> dict:
    """The semi-supervised apps at the JAX defaults, cut in depth: MNIST
    one epoch, ``main`` again to two (a resume), and two straight against
    it (``resume_equal_ssl``), cuDNN deterministic; CIFAR-10 one epoch (and,
    with ``cifar_resume``, a resume to two: cut by default to keep the
    script under 4 minutes, since this resume took 22 s of 226 on an H100;
    the CPU tests hold the CIFAR-10 resume exact); temporal ensembling one
    epoch."""
    runs = {}
    mnist_cfg = mnist_ssl_app.Config(epochs=1, out_dir=f"{out_dir}/mnist")
    print(f"train_ssl_mnist: cut for time: epochs 1, resumed to 2 (of {mnist_ssl_app.Config().epochs}); batch "
          f"{mnist_cfg.batch_size}, count {mnist_cfg.count}, lr {mnist_cfg.learning_rate} (the defaults), fp32")
    with _cudnn_deterministic():
        runs["train_ssl_mnist"] = _phase("train_ssl_mnist", phase_train_ssl, device, mnist_ssl_app, mnist_cfg)
        runs["train_ssl_mnist_resume"] = _phase("train_ssl_mnist_resume", phase_train_ssl, device, mnist_ssl_app,
                                                dataclasses.replace(mnist_cfg, epochs=2), start=1)
        diff = _phase("resume_equal_ssl", phase_resume_equal_ssl, device, mnist_cfg.out_dir,
                      dataclasses.replace(mnist_cfg, epochs=2, out_dir=f"{out_dir}/mnist_straight"))
    cifar_cfg = cifar_ssl_app.Config(epochs=1, out_dir=f"{out_dir}/cifar")
    print(f"train_ssl_cifar: cut for time: epochs 1{', resumed to 2' if cifar_resume else ', no resume'} (of "
          f"{cifar_ssl_app.Config().epochs}); batch {cifar_cfg.batch_size}, count {cifar_cfg.count}, "
          f"lr {cifar_cfg.learning_rate} "
          f"(the defaults), fp32 (TF32 convs)")
    runs["train_ssl_cifar"] = _phase("train_ssl_cifar", phase_train_ssl, device, cifar_ssl_app, cifar_cfg)
    if cifar_resume:
        runs["train_ssl_cifar_resume"] = _phase("train_ssl_cifar_resume", phase_train_ssl, device, cifar_ssl_app,
                                                dataclasses.replace(cifar_cfg, epochs=2), start=1)
    te_cfg = cifar_ssl_app.Config(epochs=1, temporal_ensembling=True, out_dir=f"{out_dir}/te")
    runs["train_ssl_te"] = _phase("train_ssl_te", phase_train_ssl, device, cifar_ssl_app, te_cfg)
    return {"runs": runs, "resume_equal": diff}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    t0 = time.perf_counter()
    smi, clock_hz = _phase("device", phase_device)
    _phase("build", phase_build)
    kernels = _phase("kernel", phase_kernel, device, clock_hz)
    capture = _phase("capture", phase_capture, device)
    draws = _phase("draws", phase_draws, device)
    _phase("cuda_vs_cpu", phase_cuda_vs_cpu, device)
    _phase("cuda_vs_cpu_bf16", phase_cuda_vs_cpu, device, precision="bfloat16")
    gan_vs_cpu = {
        "wgan-ct fp32": _phase("cuda_vs_cpu_gan", phase_cuda_vs_cpu_gan, device),
        "wgan-ct bf16": _phase("cuda_vs_cpu_gan_bf16", phase_cuda_vs_cpu_gan, device, precision="bfloat16"),
        "wgan-gp fp32": _phase("cuda_vs_cpu_gan_wgan_gp", phase_cuda_vs_cpu_gan, device, mode="wgan-gp"),
    }
    dcgan_vs_cpu = {p: _phase(f"cuda_vs_cpu_dcgan_{p}", phase_cuda_vs_cpu_dcgan, device, precision=p)
                    for p in ("float32", "bfloat16")}
    dcgan_ref = _phase("dcgan_ref", phase_dcgan_ref, device)
    ssl_vs_cpu = {v: _phase(f"cuda_vs_cpu_ssl_{v}", phase_cuda_vs_cpu_ssl, device, variant=v,
                            batch=20 if v == "mnist" else 4) for v in ("mnist", "cifar", "te")}
    ssl_ref = _phase("ssl_ref", phase_ssl_ref, device)
    lsun128_ref = _phase("lsun128_ref", phase_lsun128_ref, device)
    lsun128_vs_cpu = {p: _phase(f"cuda_vs_cpu_lsun128_{p}", phase_cuda_vs_cpu_lsun128, device, precision=p)
                      for p in ("float32", "bfloat16")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        cfg = app.Config(ITERS=TRAIN_ITERS, save_every=5, sample_every=5, INCEPTION_FREQUENCY=10,
                         inception_samples=5000, out_dir=f"{out_dir}/bf16")
        print(f"train: cut for time: ITERS {TRAIN_ITERS} (of 100000), inception_samples 5000 "
              f"(of 50000); scorer fitted for 3 epochs on the card; BF16 {cfg.BF16} (the default)")
        train = _phase("train", phase_train, device, cfg)
        resume = _phase("train_resume", phase_resume, device, cfg)
        fp32_cfg = dataclasses.replace(cfg, BF16=False, out_dir=f"{out_dir}/fp32")
        train_fp32 = _phase("train_fp32", phase_train, device, fp32_cfg)
        norm_cfg = app.Config(ITERS=4, save_every=2, sample_every=2, INCEPTION_FREQUENCY=0,
                              NORMALIZATION_D=True, out_dir=f"{out_dir}/norm_d")
        norm_d = _phase("train_norm_d", phase_train, device, norm_cfg)
        dcgan_runs = run_dcgan_apps(device, out_dir, scorer=Path(out_dir) / "bf16" / "scorer.npz")
    resume_diff = {p: _phase(f"resume_equal_{p}", phase_resume_equal, device, precision=p)
                   for p in ("float32", "bfloat16")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_jax_") as out_dir:
        jax_ckpt = _phase("jax_checkpoint", phase_jax_checkpoint, device, out_dir)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_64_") as out_dir:
        cfg64 = app64.Config(ITERS=TRAIN64_ITERS, save_every=5, sample_every=5, inception_every=10,
                             out_dir=f"{out_dir}/bf16")
        print(f"train64: cut for time: ITERS {TRAIN64_ITERS} (of 200000); IS on {cfg64.inception_samples} "
              f"(the default); scorer fitted for 3 epochs on the card; BF16 {cfg64.BF16} (the default)")
        train64 = _phase("train64", phase_train64, device, cfg64)
        resume64 = _phase("train64_resume", phase_train64, device,
                          dataclasses.replace(cfg64, ITERS=RESUME64_ITERS), start=TRAIN64_ITERS)
        train64_fp32 = _phase("train64_fp32", phase_train64, device, dataclasses.replace(
            cfg64, ITERS=4, BF16=False, save_every=2, sample_every=2, inception_every=0, out_dir=f"{out_dir}/fp32"))
    resume64_diff = {p: _phase(f"resume_equal_gan_{p}", phase_resume_equal_gan, device, precision=p)
                     for p in ("float32", "bfloat16")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_good64_") as out_dir:
        good64_ckpt = _phase("good64_checkpoint", phase_good64_checkpoint, device, out_dir)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ssl_") as out_dir:
        ssl_runs = run_ssl_apps(device, out_dir)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lsun128_") as out_dir:
        lsun_runs = run_lsun128_apps(device, out_dir)
    runs = {"train": train, "resume": resume, "train_fp32": train_fp32, "train_norm_d": norm_d,
            "jax_checkpoint": jax_ckpt, "train64": train64, "train64_resume": resume64,
            "train64_fp32": train64_fp32, **dcgan_runs["runs"], **ssl_runs["runs"], **lsun_runs["runs"]}
    launches = {"dropout_mask": sum(r["launches"] for r in runs.values()),
                "philox_uniform": sum(r["uniform_launches"] for r in runs.values())}
    print(f"train: {json.dumps(dataclasses.asdict(cfg) | {'out_dir': '<tmp>'})}")
    print(_train_line("train (bf16)", train))
    print(_train_line("train_fp32", train_fp32))
    print(_train_line("train_norm_d (bf16)", norm_d))
    print(f"train_resume: {resume['line']}; {resume['seconds']:.2f} s, "
          f"launches {resume['launches']} + {resume['uniform_launches']}")
    print(f"resume_equal: max param diff {json.dumps(resume_diff)}")
    print(f"draws: {json.dumps(draws)}")
    print(f"capture: {json.dumps(capture)}")
    print(f"serve: {json.dumps(jax_ckpt['serve'])}")
    print(f"cuda_vs_cpu_gan: max param diff {json.dumps(gan_vs_cpu)}")
    print(f"train64: {json.dumps(dataclasses.asdict(cfg64) | {'out_dir': '<tmp>'})}")
    print(_train64_line("train64 (bf16)", train64))
    print(_train64_line("train64_resume (bf16)", resume64))
    print(_train64_line("train64_fp32", train64_fp32))
    print(f"resume_equal_gan: max param diff {json.dumps(resume64_diff)}")
    print(f"good64_checkpoint: {json.dumps(good64_ckpt['scores'])}; cpu diff {good64_ckpt['cpu_diff']:.3g}")
    print(f"serve good64: {json.dumps(good64_ckpt['serve'])}")
    print(f"cuda_vs_cpu_dcgan: max param diff {json.dumps(dcgan_vs_cpu)}")
    print(f"dcgan_ref: largest gap to the JAX package's pinned outputs {json.dumps(dcgan_ref)}")
    for name, run in dcgan_runs["runs"].items():
        print(_dcgan_line(name, run))
    print(f"serve mnist, cifar: {json.dumps(dcgan_runs['serve'])}")
    print(f"cuda_vs_cpu_ssl: {json.dumps(ssl_vs_cpu)}")
    print(f"ssl_ref: {json.dumps(ssl_ref)}")
    for name, run in ssl_runs["runs"].items():
        print(_ssl_line(name, run))
    print(f"resume_equal_ssl: max diff {ssl_runs['resume_equal']}")
    print(f"lsun128_ref: largest gap to the JAX package's pinned outputs {lsun128_ref:.3g}")
    print(f"cuda_vs_cpu_lsun128: max param diff {json.dumps(lsun128_vs_cpu)}")
    for name, run in lsun_runs["runs"].items():
        print(_gan_line(name, run))
    print(f"serve lsun128: {json.dumps(lsun_runs['serve'])}")
    for name, key in (("dropout_mask", "launches"), ("philox_uniform", "uniform_launches")):
        print(f"{name} launches on the main path: "
              + " + ".join(f"{k} {r[key]}" for k, r in runs.items()) + f" = {launches[name]}")
        if not launches[name]:
            raise AssertionError(f"{name} was not launched on the main path")
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(f"card: {smi}")
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": k["route"], "source": k["source"], "replaces": k["replaces"],
         "launches": launches[k["name"]], **{f: k[f] for f in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
