"""Rehearsal on the CPU of ``chip_smoke.py``'s new phases: the synthetic
Inception-2015 graph (``tests/torch_inception_graph.py``), ``INCEPTION_REF``
recomputed with the JAX package on the CPU, ``inception_ref`` with the port
on the CPU against it, ``aot_equal`` at full width in fp32 on the JAX run's
checkpoint, the toys through the CLI (``--platform cpu``) and ``cli``.

The JAX package's Inception2015 runs the full-width graph in about 8 s on
the CPU, so no case is cut in depth."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from ctgan_tpu.eval.inception2015 import Inception2015 as JaxInception2015
from ctgan_tpu.eval.graphdef import parse_graphdef as jax_parse

from ctgan_tpu_torch.eval.inception2015 import SUPPORTED_OPS

import torch_inception_graph as tig
import torch_parity  # noqa: F401  (one intra-op thread per test worker)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    pb = tmp_path_factory.mktemp("inception") / "classify_image_graph_def.pb"
    return pb, tig.write_inception_graph(pb)


def test_the_synthetic_graph_has_the_published_architecture(graph):
    """94 convs, about 24 M weights (95 MB), every op supported, 2048
    features and 1008 classes; the real graph's names on the path."""
    pb, info = graph
    assert info["convs"] == 94 and 23_000_000 < info["weights"] < 25_000_000
    assert 90e6 < info["bytes"] < 100e6
    nodes = {n.name: n for n in jax_parse(pb.read_bytes())}
    assert {n.op for n in nodes.values()} - {"Placeholder"} <= SUPPORTED_OPS
    assert nodes["softmax/logits/MatMul"].inputs == ["pool_3/_reshape", "softmax/weights"]
    for name in ("ExpandDims", "ResizeBilinear", "Sub", "Mul", "conv", "pool_1", "mixed/join", "mixed_3/join",
                 "mixed_8/join", "mixed_10/join", "pool_3"):
        assert name in nodes, name
    reduced, counts = tig.inception_graphdef(blocks=tig.REDUCED_BLOCKS)
    assert counts["convs"] == 5 + 7 + 4 and len(reduced) < info["bytes"]


def test_inception_ref_is_pinned(chip_smoke, graph):
    """``INCEPTION_REF`` is the JAX package's output on the CPU (to a tenth
    of the card's bounds: the JAX CPU run is the same computation)."""
    pb, _ = graph
    feats, probs = JaxInception2015(str(pb)).predictions(chip_smoke.inception_ref_images())
    got = chip_smoke.inception_ref_summary(feats, probs)
    gaps = chip_smoke.inception_ref_gaps(got, chip_smoke.INCEPTION_REF)
    assert gaps["pool_3"] <= 1e-5 and gaps["softmax"] <= 1e-6 and gaps["is"] <= 1e-5, gaps
    assert 0.4 < min(got["prob_max"]) and max(got["prob_max"]) < 0.6  # neither uniform nor one-hot


def test_inception_ref_phase_rehearses_on_cpu(chip_smoke, graph):
    """The port on the CPU holds the pinned JAX outputs within the phase's
    bounds (pool_3 1e-4 of the largest feature, softmax 1e-5, IS 1e-4)."""
    pb, info = graph
    out = chip_smoke.phase_inception_ref("cpu", pb, info)
    assert out["convs"] == 94 and all(v <= 1e-4 for v in out["gaps"].values())


def test_aot_equal_rehearses_on_cpu(chip_smoke, tmp_path):
    """The JAX run's dim-128 G exported at batch 100: ``--aot`` equals eager
    bit for bit in fp32; another recorded device name raises."""
    assert chip_smoke.aot_equal("cpu", str(tmp_path), chip_smoke.AOT_CKPT, bf16=False) == 0.0


def test_onehot_toys_and_cli_phases_rehearse_on_cpu(chip_smoke, tmp_path):
    """At 200 iterations of a small batch and width (the card runs the
    defaults)."""
    toys = chip_smoke.phase_onehot_toys("cpu", str(tmp_path), iters=200,
                                        flags=("--BATCH_SIZE", "8", "--DIM", "16", "--OUTPUT_DIM", "32"))
    assert set(toys) == {"wgan", "ae"} and all(np.isfinite(v["s_per_iter"]) for v in toys.values())
    assert chip_smoke.phase_cli() == {"list": 0, "unknown": 2, "apps": 9}
