"""The port runs where JAX is not installed: no module of
``ctgan_tpu_torch``, not ``chip_smoke.py``, not the graph writer it
imports (``tests/torch_inception_graph.py``) and not the processes the
parallel and entry tests spawn (``tests/torch_parallel_workers.py``,
``tests/torch_entry_workers.py``) imports ``jax``,
``jaxlib`` or the JAX package ``ctgan_tpu``."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "ctgan_tpu"}
EXTRA = [ROOT / "tests" / "torch_inception_graph.py", ROOT / "tests" / "torch_parallel_workers.py",
         ROOT / "tests" / "torch_entry_workers.py", ROOT / "chip_smoke.py"]
FILES = sorted((ROOT / "ctgan_tpu_torch").rglob("*.py")) + EXTRA


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_the_scan_sees_the_port():
    assert len(FILES) > 20 and all(f.is_file() for f in FILES)
    names = {str(f.relative_to(ROOT / "ctgan_tpu_torch")) for f in FILES[:-len(EXTRA)]}
    assert {"models/dcgan.py", "models/fc.py", "ops/activations.py", "ops/init.py", "data/mnist.py",
            "data/synthetic.py", "apps/ct_gan_mnist.py", "apps/ct_gan_cifar.py"} <= names
    assert {"ops/noise.py", "ops/weightnorm.py", "train/wn_init.py", "train/trainer_semisup.py",
            "models/classifiers.py", "losses/semisup.py", "apps/ssl_common.py", "apps/ct_mnist_ssl.py",
            "apps/ct_cifar_ssl.py", "apps/profile_ssl.py"} <= names
    assert {"models/lsun128.py", "apps/wgan_lsun128.py", "data/images_dir.py", "data/native.py"} <= names
    assert {"eval/graphdef.py", "eval/inception2015.py", "utils/aot.py", "__main__.py",
            "apps/onehot_toys.py"} <= names
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/spmd.py", "parallel/collectives.py"} <= names
    assert {"train/remat.py", "train/recalibrate.py", "ops/recurrent.py", "ops/embedding.py", "ops/mlp.py",
            "ops/stats.py", "ops/minibatch.py", "ops/lsuv.py"} <= names
    assert {"data/aux_loaders.py", "utils/experiments.py", "utils/random_search.py", "utils/handwriting.py",
            "entry.py", "parallel/launch.py", "eval/calibrate.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_the_scan_catches_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import numpy\nfrom ctgan_tpu.ops import conv\nimport ctgan_tpu_torch\n")
    assert _imported_roots(bad) & FORBIDDEN == {"ctgan_tpu"}
