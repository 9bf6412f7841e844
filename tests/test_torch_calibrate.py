"""``python -m ctgan_tpu_torch.eval.calibrate`` against
``tools/calibrate_inception.py`` (called in-process with ``--cpu``,
unedited) on the CPU, on the reduced synthetic Inception-2015 graph
(``tests/torch_inception_graph.py``, ``REDUCED_BLOCKS``) at ``--n 8
--batch 4 --splits 2``.

Tolerances: the op census (``nodes``, ``ops``, ``gaps``) and the protocol's
shapes equal; the inception score within 1e-4 of JAX's, relative.  A graph
with an op outside ``SUPPORTED_OPS`` exits 2 in both, before anything runs.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import pytest

from ctgan_tpu_torch.eval import calibrate

import torch_inception_graph as tig
import torch_parity  # noqa: F401  (one intra-op thread per test worker)

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--n", "8", "--batch", "4", "--splits", "2", "--cpu"]


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("calibrate_inception", ROOT / "tools" / "calibrate_inception.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def reduced_pb(tmp_path_factory):
    pb = tmp_path_factory.mktemp("calibrate") / "classify_image_graph_def.pb"
    tig.write_inception_graph(pb, blocks=tig.REDUCED_BLOCKS)
    return pb


def _run(tool_main, argv, capsys, monkeypatch, jax_style: bool):
    if jax_style:  # the JAX tool reads sys.argv
        monkeypatch.setattr(sys, "argv", ["calibrate_inception.py", *argv])
        code = tool_main()
    else:
        code = tool_main(argv)
    out = capsys.readouterr().out
    return code, out


def test_calibrate_equals_the_jax_tool(jax_tool, reduced_pb, capsys, monkeypatch):
    argv = ["--pb", str(reduced_pb), *ARGS]
    want_code, want_out = _run(jax_tool.main, argv, capsys, monkeypatch, jax_style=True)
    got_code, got_out = _run(calibrate.main, argv, capsys, monkeypatch, jax_style=False)
    assert got_code == want_code == 0
    want, got = (json.loads(out.strip().splitlines()[-1]) for out in (want_out, got_out))
    for key in ("nodes", "ops", "gaps", "pool_dim", "classes", "source"):
        assert got[key] == want[key], key
    assert got["gaps"] == 0 and got["images_per_s"] > 0
    for key in ("is_mean", "is_std"):
        assert got[key] == pytest.approx(want[key], rel=1e-4), key
    strip = lambda out: [line.split(" in ")[0] for line in out.splitlines() if "ops used" in line]
    assert strip(got_out) == strip(want_out)


def test_calibrate_exits_2_on_an_unknown_op(jax_tool, reduced_pb, tmp_path, capsys, monkeypatch):
    bad = tmp_path / "bad.pb"
    bad.write_bytes(reduced_pb.read_bytes().replace(b"\x12\x04Relu", b"\x12\x04Relx"))
    argv = ["--pb", str(bad), *ARGS]
    want_code, want_out = _run(jax_tool.main, argv, capsys, monkeypatch, jax_style=True)
    got_code, got_out = _run(calibrate.main, argv, capsys, monkeypatch, jax_style=False)
    assert got_code == want_code == 2
    assert "UNSUPPORTED OPS" in got_out and "Relx" in got_out
    gaps = lambda out: [line.strip() for line in out.splitlines() if line.startswith("  Relx")]
    assert gaps(got_out) == gaps(want_out) != []


def test_calibrate_without_a_graph_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("CTGAN_INCEPTION_PB", raising=False)
    monkeypatch.setattr("ctgan_tpu_torch.eval.calibrate.find_inception_file", lambda path: None)
    with pytest.raises(FileNotFoundError, match="CTGAN_INCEPTION_PB"):
        calibrate.main(["--pb", str(tmp_path / "missing.pb"), "--cpu"])
