#!/usr/bin/env python3
"""Smoke run of ``ctgan_tpu_torch`` on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its seconds:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` builds every CUDA kernel (ptxas report on stderr);
3. kernel: the dropout-mask kernel against its plain PyTorch version at the
   flagship's three training mask shapes (fp32 and bf16) and its two
   dev-cost shapes (fp32), keep prob 0.8 and 0.5: bit for bit, keep
   fraction, determinism; then its time beside its byte bound, the plain
   version's time and ``bernoulli_``'s;
4. cuda_vs_cpu: two flagship iterations at dim 16 on the card and on the
   CPU with the same draws (masks from the kernel on the card, from the
   plain version on the CPU), TF32 off, params compared;
5. train: the flagship app (``apps.ct_gan_cifar_resnet.main``) at full
   width for 10 iterations in a temporary ``out_dir``, through the train
   loop: checkpoints every 5 iterations, a sample grid and the dev cost
   every 5, IS and FID at iteration 9 over 5,000 generated images (cut from
   50,000 for time) with a TrainedScorer fitted on the card; the files are
   checked and the grids decoded.  Then ``main`` again with ``ITERS=12`` in
   the same directory, which must resume at iteration 10.  The kernel's
   launches are counted in each call;
6. resume_equal: at dim 16, with cuDNN deterministic, 4 iterations
   uninterrupted against 2 + checkpoint + a fresh trainer + 2;
7. jax_checkpoint: the JAX package's dim-128 checkpoint
   ``runs/flagship_fused_r4/ckpt/ckpt_25000.npz`` and its scorer
   ``scorer.npz`` (sha256 printed) loaded into the port; the app's
   ``test_fn`` as the JAX app ran it at iteration 24999 (dev cost, IS over
   50,000 samples in chunks of 5,000, FID on 10,000), each beside the JAX
   run's logged value, with ``|IS - 9.70838| <= 0.30`` as the gate against
   layout and loading errors, and the dev cost's spread over 8 other
   seeds of its draws; then ``apps.generate`` on the same checkpoint: a
   100-sample grid, and ``--batch 1024 --serve_iters 20``.

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
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from ctgan_tpu_torch.apps import ct_gan_cifar_resnet as app
from ctgan_tpu_torch.apps import generate
from ctgan_tpu_torch.bridge import from_jax_params, state_from_jax, state_to_jax
from ctgan_tpu_torch.core import Randomness, split_params
from ctgan_tpu_torch.data import DeviceSampler
from ctgan_tpu_torch.eval import TrainedScorer
from ctgan_tpu_torch.kernels import SOURCES, dropout_mask, dropout_mask_reference
from ctgan_tpu_torch.kernels.build import build_libraries
from ctgan_tpu_torch.models import resnet_cifar
from ctgan_tpu_torch.train import AcganConfig, AcganTrainer
from ctgan_tpu_torch.train.optim import adam_mismatches
from ctgan_tpu_torch.utils import load_checkpoint, save_checkpoint

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
TRAIN_ITERS = 10
RESUME_ITERS = 12
ROOT = Path(__file__).resolve().parent
JAX_RUN = ROOT / "runs" / "flagship_fused_r4"
# what the JAX run logged at iteration 24999 (runs/flagship_fused_r4/log.pkl)
JAX_LOGGED = {"inception_50k": 9.70838, "fid_10k": 0.23079, "dev_cost": -0.80976}
IS_GATE = 0.30
DEV_COST_SEEDS = range(2, 10)


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


def dev_cost_mask_shapes(dim: int = 128, n_dev: int = 640):
    """NCHW shapes of the dev cost's masks: fused CT pair over ``n_dev``
    dev examples, GP."""
    return [(4 * n_dev, dim, 8, 8), (n_dev, dim, 8, 8)]


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
    for shape in dev_cost_mask_shapes():
        for kp in (0.8, 0.5):
            got = dropout_mask(seed, shape, kp, torch.float32, device)
            torch.cuda.synchronize()
            want = dropout_mask_reference(seed, shape, kp, torch.float32, device)
            max_err = max(max_err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"kernel != plain version at {shape} fp32 kp {kp}")
            del got, want
    tail = dropout_mask(7, (1001,), 0.5, torch.bfloat16, device)  # ragged tail
    if not torch.equal(tail, dropout_mask_reference(7, (1001,), 0.5, torch.bfloat16, device)):
        raise AssertionError("kernel != plain version on a ragged tail")

    times = {}
    for shape in flagship_mask_shapes():
        for dtype in (torch.float32, torch.bfloat16):
            times[f"{list(shape)} {str(dtype)[6:]}"] = _time_ms(
                lambda: dropout_mask(seed, shape, 0.5, dtype, device), 200)
    for shape in dev_cost_mask_shapes():
        times[f"{list(shape)} float32"] = _time_ms(
            lambda: dropout_mask(seed, shape, 0.5, torch.float32, device), 100)
    print("kernel_ms " + json.dumps(times))
    print("kernel_byte_bound_ms " + json.dumps({
        f"{list(s)} float32": math.prod(s) * 4 / HBM_BYTES_PER_S * 1e3
        for s in flagship_mask_shapes() + dev_cost_mask_shapes()}))
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
    """``app.main`` with the kernel's launches counted and stdout kept.
    Returns (state, records, launches, stdout, seconds)."""
    dropout_mask.launches = 0
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        state, records = app.main(cfg=cfg, device=device)
    return state, records, dropout_mask.launches, tee.buf.getvalue(), time.perf_counter() - t0


def _test_iterations(cfg: app.Config, start: int) -> list[int]:
    return [it for it in range(start, cfg.ITERS) if it % cfg.sample_every == cfg.sample_every - 1]


def _expected_launches(cfg: app.Config, start: int, device) -> int:
    """Per iteration: G substep 3 masks; each critic substep 3 (CT pair) +
    3 (GP); the kp=1 clean pass makes none.  Per test_fn: the dev cost's
    3 + 3; G has no dropout."""
    if torch.device(device).type != "cuda":
        return 0
    return (cfg.ITERS - start) * (3 + 6 * cfg.N_CRITIC) + 6 * len(_test_iterations(cfg, start))


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
    state, records, launches, stdout, seconds = _run_main(cfg, device)
    fit = re.search(r"IS scorer: fitted in ([0-9.]+) s", stdout)
    expected = _expected_launches(cfg, 0, device)
    if launches != expected:
        raise AssertionError(f"dropout_mask launched {launches} times, expected {expected}")
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
    if samples.shape != (100, 3072) or not bool(torch.isfinite(samples).all()) or samples.abs().max() > 1:
        raise AssertionError("generator samples are not finite [100, 3072] values in [-1, 1]")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    steps = [r["time"] for r in records if 1 <= r["iteration"] <= 3]
    return dict(launches=launches, s_per_iter=float(np.mean(steps)) if steps else None,
                peak_bytes=peak, last=last, seconds=seconds, evals=evals,
                scorer_fit_s=float(fit.group(1)) if fit else None)


def phase_resume(device, cfg: app.Config) -> dict:
    """``main`` again in the same ``out_dir`` with more iterations: it must
    resume where the last checkpoint left off and train on."""
    start = cfg.ITERS - cfg.ITERS % cfg.save_every if cfg.save_every else 0
    more = dataclasses.replace(cfg, ITERS=cfg.ITERS + (RESUME_ITERS - TRAIN_ITERS))
    state, records, launches, stdout, seconds = _run_main(more, device)
    want = f"resumed from {Path(cfg.out_dir) / 'ckpt' / f'ckpt_{start}.npz'} at iteration {start}"
    if want not in stdout:
        raise AssertionError(f"no line {want!r} in the resumed run's output")
    expected = _expected_launches(more, start, device)
    if launches != expected:
        raise AssertionError(f"dropout_mask launched {launches} times on resume, expected {expected}")
    if state.step != more.ITERS or records[-1]["iteration"] != more.ITERS - 1:
        raise AssertionError(f"resumed run ended at step {state.step}, records {records[-1]}")
    return dict(launches=launches, seconds=seconds, start=start, line=want)


def phase_resume_equal(device, *, dim=16, batch=4, n_critic=2, iters=4, seed=0) -> float:
    """``iters`` iterations uninterrupted, against ``iters // 2``, a
    checkpoint written and read back into a fresh trainer, and the rest;
    cuDNN deterministic.  Params by ``adam_mismatches``.  Returns the
    largest param difference."""
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
    print(f"resume_equal on {device}: {iters // 2} + checkpoint + {iters - iters // 2} iterations "
          f"vs {iters}: max param diff {diff:.3g}")
    return diff


def _sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def phase_jax_checkpoint(device, out_dir: str) -> dict:
    """The JAX run's dim-128 checkpoint scored by the port as the JAX app
    scored it at iteration 24999; then ``apps.generate`` on it.  Card
    only."""
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

    dropout_mask.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    quick = test_fn(state, 24998)  # returns host floats: synchronised
    test_s = time.perf_counter() - t0
    test_peak = torch.cuda.max_memory_allocated(device) - base
    t0 = time.perf_counter()
    full = test_fn(state, 24999)
    eval_s = time.perf_counter() - t0
    # the dev cost's spread over its draws (fake noise and labels, dropout,
    # GP alphas, dequantisation): test_fn draws from seed 1 only
    n_dev = cfg.BATCH_SIZE * 10
    dev_x, dev_y = (torch.from_numpy(a[:n_dev]).to(device) for a in flagship.data["test"])
    spread = [float(flagship.trainer.dev_cost(state, dev_x, dev_y, Randomness(seed, device)))
              for seed in DEV_COST_SEEDS]
    launches = dropout_mask.launches
    expected = 6 * (2 + len(DEV_COST_SEEDS))
    if launches != expected:
        raise AssertionError(f"dropout_mask launched {launches} times in the dev costs, expected {expected}")
    grid = decode_png(Path(out_dir) / "samples_24999.png")
    if grid.shape != (320, 320, 3):
        raise AssertionError(f"samples_24999.png is {grid.shape}")
    for k, v in JAX_LOGGED.items():
        print(f"jax_checkpoint {k}: port {full[k]:.5f}, JAX run logged {v}")
    print(f"jax_checkpoint dev_cost over seeds {list(DEV_COST_SEEDS)}: "
          f"{' '.join(f'{v:.5f}' for v in spread)} (mean {np.mean(spread):.5f}, "
          f"min {min(spread):.5f}, max {max(spread):.5f})")
    print(f"jax_checkpoint inception_50k_std: port {full['inception_50k_std']:.5f}; "
          f"test_fn without IS {test_s:.3f} s, with IS over {cfg.inception_samples} and FID {eval_s:.3f} s; "
          f"peak device memory of test_fn without IS above the state {test_peak / 2**30:.3f} GiB")
    if not all(math.isfinite(full[k]) for k in JAX_LOGGED):
        raise AssertionError(f"non-finite eval: {full}")
    if abs(full["inception_50k"] - JAX_LOGGED["inception_50k"]) > IS_GATE:
        raise AssertionError(f"IS {full['inception_50k']} is not within {IS_GATE} of "
                             f"{JAX_LOGGED['inception_50k']}: layouts or loading are wrong")

    prefix = str(Path(out_dir) / "generated")
    samples = generate.main(cfg=generate.Config(ckpt=str(ckpt), n=100, out_prefix=prefix), device=device)
    if samples.shape != (100, 3072) or not np.isfinite(samples).all() or np.abs(samples).max() > 1:
        raise AssertionError("generate: samples are not finite [100, 3072] values in [-1, 1]")
    if decode_png(prefix + ".png").shape != (320, 320, 3):
        raise AssertionError("generate: the grid does not decode to 320x320 RGB")
    serve = generate.main(cfg=generate.Config(ckpt=str(ckpt), batch=1024, serve_iters=20), device=device)
    if dropout_mask.launches != launches:
        raise AssertionError("generate launched the dropout kernel; G has no dropout")
    return dict(launches=launches, eval=full, quick=quick, test_s=test_s, eval_s=eval_s,
                test_peak_bytes=test_peak, serve=serve, dev_cost_spread=spread)


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
        cfg = app.Config(ITERS=TRAIN_ITERS, save_every=5, sample_every=5, INCEPTION_FREQUENCY=10,
                         inception_samples=5000, out_dir=out_dir)
        print(f"train: cut for time: ITERS {TRAIN_ITERS} (of 100000), inception_samples 5000 "
              f"(of 50000); scorer fitted for 3 epochs on the card")
        train = _phase("train", phase_train, device, cfg)
        resume = _phase("train_resume", phase_resume, device, cfg)
    resume_diff = _phase("resume_equal", phase_resume_equal, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_jax_") as out_dir:
        jax_ckpt = _phase("jax_checkpoint", phase_jax_checkpoint, device, out_dir)
    launches = train["launches"] + resume["launches"] + jax_ckpt["launches"]
    print(f"train: {json.dumps(dataclasses.asdict(cfg) | {'out_dir': '<tmp>'})}")
    print(f"train: {train['s_per_iter']:.5f} s/iter over iterations 1-3, "
          f"{train['seconds']:.2f} s for main (setup, scorer fit, {TRAIN_ITERS} iterations, "
          f"2 test_fn, 2 checkpoints; scorer fit {train['scorer_fit_s']} s), "
          f"peak {train['peak_bytes'] / 2**30:.3f} GiB, "
          f"launches {train['launches']}, evals {json.dumps(train['evals'])}, "
          f"last {json.dumps(train['last'])}")
    print(f"train_resume: {resume['line']}; {resume['seconds']:.2f} s, launches {resume['launches']}")
    print(f"resume_equal: max param diff {resume_diff:.3g}")
    print(f"serve: {json.dumps(jax_ckpt['serve'])}")
    print(f"launches on the main path: train {train['launches']} + resume {resume['launches']} "
          f"+ jax_checkpoint {jax_ckpt['launches']} = {launches}")
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(f"card: {smi}")
    print(json.dumps({"kernels": [{
        "name": "dropout_mask", "route": "cuda", "source": "ctgan_tpu_torch/csrc/dropout_mask.cu",
        "replaces": "ctgan_tpu/kernels/dropout.py:35", "launches": launches,
        **kernel, "bound_by": "bytes",
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
