"""Calibrate the file-based Inception-2015 scorer against a graph file
(counterpart of ``tools/calibrate_inception.py``):

    python -m ctgan_tpu_torch.eval.calibrate [--pb PATH] [--data_dir DIR]
        [--n 10000] [--batch 100] [--splits 10] [--cpu]

1. The op census: every node on the path from the ``ExpandDims`` feed to
   ``pool_3``, and each op outside ``SUPPORTED_OPS`` named before anything
   runs.
2. The protocol's shapes on a probe batch of four 32 px images drawn from
   ``default_rng(0)``: ``pool_3`` gives ``[B, 2048]`` features, the
   bias-free logits ``[B, 1008]`` softmax rows that sum to 1.
3. One score pass: the CIFAR-10 test set when ``--data_dir`` holds its
   pickle batches, else up to 1,000 uniform images from the same generator.

The graph is ``--pb``, else ``$CTGAN_INCEPTION_PB``, else the reference's
``/tmp/imagenet`` cache.  It runs on the card unless ``--cpu`` is given.
Exit status 0 when the scorer covers the graph and the checks pass, 2 when
ops are missing (the report printed, nothing run).  The last line is a JSON
object: ``nodes``, ``ops``, ``gaps``, ``pool_dim``, ``classes``,
``is_mean``, ``is_std``, ``source``, and ``images_per_s`` of the score pass.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .graphdef import parse_graphdef
from .inception2015 import SUPPORTED_OPS, Inception2015, _Executor, find_inception_file, load_graphdef_bytes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pb", default=None, help=".pb or .tgz (default: $CTGAN_INCEPTION_PB / /tmp/imagenet)")
    ap.add_argument("--data_dir", default=os.environ.get("DATA_DIR", ""),
                    help="CIFAR-10 pickle-batch directory for the real-data score pass")
    ap.add_argument("--n", type=int, default=10000, help="images to score")
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--splits", type=int, default=10)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    path = find_inception_file(args.pb)
    if path is None:
        raise FileNotFoundError("no Inception-2015 graph: give --pb, set $CTGAN_INCEPTION_PB, or put "
                                "classify_image_graph_def.pb under /tmp/imagenet/")
    exe = _Executor(parse_graphdef(load_graphdef_bytes(path)), device)
    print(f"[calibrate] graph loaded: {len(exe.nodes)} nodes, {len(exe.consts)} consts")

    # 1. the op census over the execution frontier
    feed, pool = Inception2015.FEED, Inception2015.POOL
    frontier = exe.reachable(pool, feeds=(feed,))
    ops_used = sorted({n.op for n in frontier})
    gaps = exe.unsupported(pool, feeds=(feed,))
    print(f"[calibrate] execution frontier: {len(frontier)} nodes, {len(ops_used)} distinct ops")
    print(f"[calibrate] ops used: {', '.join(ops_used)}")
    if gaps:
        print("[calibrate] UNSUPPORTED OPS: implement these in "
              "ctgan_tpu_torch/eval/inception2015.py::_Executor before scoring:")
        for op, names in sorted(gaps.items()):
            print(f"  {op}: {len(names)} node(s), e.g. {names[:3]}")
        return 2
    print(f"[calibrate] op coverage OK ({len(SUPPORTED_OPS)} ops supported)")
    del exe
    inc = Inception2015(path, batch_size=args.batch, device=device)

    # 2. the protocol's shapes on one probe batch
    rng = np.random.default_rng(0)
    probe = rng.uniform(0, 255, size=(4, 32, 32, 3)).astype(np.float32)
    t0 = time.time()
    feats, preds = inc.predictions(probe)
    print(f"[calibrate] probe batch executed in {time.time() - t0:.1f}s")
    assert feats.ndim == 2 and feats.shape[0] == 4, feats.shape
    assert preds.shape[0] == 4, preds.shape
    np.testing.assert_allclose(preds.sum(axis=1), 1.0, atol=1e-4)
    print(f"[calibrate] pool_3 features: [B, {feats.shape[1]}] (reference: 2048); softmax: [B, {preds.shape[1]}] "
          "(reference: 1008); rows sum to 1 OK")
    shapes_match = feats.shape[1] == 2048 and preds.shape[1] == 1008
    if not shapes_match:
        print("[calibrate] WARNING: shapes differ from the 2015 graph: scores will not be reference-comparable")

    # 3. the score pass: the real CIFAR-10 test set if present, else synthetic
    src = "synthetic"
    if args.data_dir and os.path.exists(os.path.join(args.data_dir, "test_batch")):
        from ..data import cifar10

        d = cifar10.load_arrays(args.data_dir)
        imgs = d["test"][0][: args.n].reshape(-1, 3, 32, 32).astype(np.float32)
        src = f"cifar10 test_batch ({len(imgs)} images)"
    else:
        imgs = rng.uniform(0, 255, size=(min(args.n, 1000), 3, 32, 32)).astype(np.float32)
    t0 = time.time()
    mean, std = inc.inception_score(imgs, splits=args.splits)
    dt = time.time() - t0
    print(f"[calibrate] IS over {src}: {mean:.3f} +/- {std:.3f} ({len(imgs)} images in {dt:.1f}s, "
          f"{len(imgs) / dt:.0f} img/s)")
    if src != "synthetic" and shapes_match:
        lo, hi = 10.5, 12.0  # the published real-test-set IS band for this graph
        verdict = "COMPARABLE" if lo <= mean <= hi else "OUT OF BAND"
        print(f"[calibrate] real CIFAR-10 test-set IS expected in [{lo}, {hi}] for the 2015 graph: {verdict}")
        print("[calibrate] generated-sample baseline: the reference's 1000-example CT-GAN artifacts score "
              "IS=5.13 (M=0.0) / 5.20 (M=0.1) under this protocol")
    print(json.dumps({"nodes": len(inc.exe.nodes), "ops": len(ops_used), "gaps": sum(map(len, gaps.values())),
                      "pool_dim": int(feats.shape[1]), "classes": int(preds.shape[1]), "is_mean": float(mean),
                      "is_std": float(std), "source": src, "images_per_s": len(imgs) / dt}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
