"""How far the 128 px critic's losses move under bf16 rounding alone, on
the CPU (a script, not a test).

    python tests/torch_lsun128_bf16_probe.py

For seeds 0-2: ``chip_smoke.py``'s ``LSUN128_SMALL`` model and the LSUN
app's trainer at batch 4, one G substep and one critic substep from a fresh
state on uniform reals, in fp32 and bf16, each with the down blocks'
shortcut as mean pool then 1x1 conv and fused into one stride-2 conv (the
same math, another order of sums).  Prints each loss in the four runs, bf16
against fp32, and the two bf16 runs against each other: the spread that
bounds ``chip_smoke.py``'s bf16 loss check in ``cuda_vs_cpu_lsun128``.
Then the same pairs on that phase's two gradient checks of the critic
substep: the L1 distance of the gradients as a share of the first run's
L1 mass, and the share of that mass on elements that stepped the other way.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ctgan_tpu_torch.bridge import from_jax_params  # noqa: E402
from ctgan_tpu_torch.core import Randomness, precision_policy, split_params  # noqa: E402
from ctgan_tpu_torch.models import lsun128  # noqa: E402
from ctgan_tpu_torch.train import GanConfig, GanTrainer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def substep(cfg: lsun128.Lsun128Config, precision: str, fuse_meanpool: bool, seed: int, batch: int = 4):
    """The critic substep's losses, and each D parameter's gradient and
    step."""
    gcfg = GanConfig(mode="wgan-CT", batch_size=batch, critic_iters=2, iters=100, beta1=0.0, lr_decay=True)
    trainer = GanTrainer(
        lambda p, n, rand, noise=None: lsun128.generator(p, n, rand, cfg=cfg, noise=noise),
        lambda p, x, rand: lsun128.discriminator(p, x, rand, cfg=cfg, fuse_meanpool=fuse_meanpool), gcfg)
    gen, disc, _ = split_params(from_jax_params(lsun128.init_params(cfg, seed)), "Generator", "Discriminator")
    state = trainer.init_state(gen, disc)
    before = {k: v.detach().clone() for k, v in state.disc_params.items()}
    real = np.random.default_rng(seed).uniform(-1, 1, (2, batch, 3 * 128 * 128)).astype(np.float32)
    rand = Randomness(seed, "cpu")
    with precision_policy(precision):
        trainer.gen_substep(state, rand)
        metrics = trainer.critic_substep(state, torch.from_numpy(real[0]), rand)
    # TF-Adam's first moment after one update with beta1 0 is the gradient
    grads = {k: v.detach().double().numpy() for k, v in state.disc_opt["m"].items()}
    steps = {k: (state.disc_params[k].detach() - before[k]).double().numpy() for k in before}
    return {k: float(v) for k, v in metrics.items()}, grads, steps


def grad_gaps(ref, other) -> tuple[float, float]:
    """``chip_smoke._substep_checker``'s two gradient measures of
    ``other`` against ``ref``: the L1 distance over ``ref``'s L1 mass, and
    ``ref``'s mass on elements whose steps differ in sign."""
    (_, g_ref, s_ref), (_, g, s) = ref, other
    mass = sum(float(np.abs(v).sum()) for v in g_ref.values())
    l1 = sum(float(np.abs(g[k] - g_ref[k]).sum()) for k in g_ref)
    flipped = sum(float(np.abs(g_ref[k][np.sign(s[k]) != np.sign(s_ref[k])]).sum()) for k in g_ref)
    return l1 / mass, flipped / mass


def main() -> None:
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = chip_smoke.LSUN128_SMALL
    worst = {"bf16 vs fp32": 0.0, "bf16 fused vs plain": 0.0}
    worst_grads = {"bf16 vs fp32": (0.0, 0.0), "bf16 fused vs plain": (0.0, 0.0)}
    for seed in (0, 1, 2):
        full = {(p, f): substep(cfg, p, f, seed) for p in ("float32", "bfloat16") for f in (False, True)}
        runs = {key: out[0] for key, out in full.items()}
        grads = {"bf16 vs fp32": grad_gaps(full[("float32", False)], full[("bfloat16", False)]),
                 "bf16 fused vs plain": grad_gaps(full[("bfloat16", False)], full[("bfloat16", True)])}
        worst_grads = {n: tuple(map(max, worst_grads[n], g)) for n, g in grads.items()}
        print(f"seed {seed} critic gradients: " + ", ".join(
            f"{n} L1 {g[0]:.4g} of the mass, {g[1]:.4g} stepping the other way" for n, g in grads.items()))
        for k in ("wgan", "ct", "gp", "disc_cost"):
            fp32, bf16, fused = runs[("float32", False)][k], runs[("bfloat16", False)][k], runs[("bfloat16", True)][k]
            gaps = {"bf16 vs fp32": abs(bf16 - fp32) / abs(fp32), "bf16 fused vs plain": abs(fused - bf16) / abs(bf16)}
            worst = {n: max(worst[n], g) for n, g in gaps.items()}
            print(f"seed {seed} {k}: fp32 {fp32:.6g} (fused {runs[('float32', True)][k]:.6g}), bf16 {bf16:.6g} "
                  f"(fused {fused:.6g}); " + ", ".join(f"{n} {g:.3g}" for n, g in gaps.items()))
    print("largest relative gaps: " + ", ".join(f"{n} {g:.3g}" for n, g in worst.items()))
    print("largest gradient gaps: " + ", ".join(
        f"{n} L1 {g[0]:.4g}, other way {g[1]:.4g}" for n, g in worst_grads.items())
        + f" (chip_smoke.py's bf16 bounds: L1 {chip_smoke.BF16_GRAD_BOUND}, other way {chip_smoke.BF16_BOUND})")


if __name__ == "__main__":
    main()
