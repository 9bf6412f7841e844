"""The port's Inception-2015 scorer (``ctgan_tpu_torch/eval/graphdef.py``,
``eval/inception2015.py``, ``apps/common.py::pick_scorer``) against the JAX
package's on the CPU, on GraphDefs encoded by hand (the encoders of
``tests/test_inception2015.py`` and ``tests/test_inception2015_torch_diff.py``).

Tolerances: both executors compute in fp32 on the CPU with other kernels
(XLA's against PyTorch's convs and pools, other summation orders), so each
op family is held within 1e-5 relative and 1e-5 absolute (the convs and the
composed graphs 1e-4, fp32 sums of up to 245 products); graphs of pure
indexing or shape arithmetic are held equal; the mini graph's IS and FID
within 1e-5 relative.
"""

from __future__ import annotations

import tarfile

import numpy as np
import pytest
import torch

from ctgan_tpu.apps import common as jax_common
from ctgan_tpu.eval import inception2015 as jax_inception
from ctgan_tpu.eval.graphdef import parse_graphdef as jax_parse

from ctgan_tpu_torch.apps import common
from ctgan_tpu_torch.eval import Inception2015, TrainedScorer
from ctgan_tpu_torch.eval import inception2015 as port_inception
from ctgan_tpu_torch.eval.graphdef import parse_graphdef, tensor_to_numpy

import torch_parity  # noqa: F401  (one intra-op thread per test worker)
from test_inception2015 import (
    _attr_b,
    _attr_f,
    _attr_i,
    _attr_list_i,
    _attr_s,
    _attr_type,
    _const,
    _extended_ops_graphdef,
    _mini_inception_graphdef,
    _node,
)
from test_inception2015_torch_diff import _conv_graph, _pool_graph


def _both(graph: bytes, target: str, feeds: dict) -> tuple[np.ndarray, np.ndarray]:
    """``target`` through JAX's ``_Executor`` and the port's (on the CPU)."""
    want = np.asarray(jax_inception._Executor(jax_parse(graph)).run(target, feeds))
    got = port_inception._Executor(parse_graphdef(graph), "cpu").run(target, feeds)
    return torch.as_tensor(got).cpu().numpy(), want


def _normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


# ------------------------------------------------------------------ parsing

def test_parse_round_trips_consts_and_attrs():
    """Every field the executor reads parses as the JAX parser parses it."""
    graph = (_const("f", np.arange(24, dtype=np.float32).reshape(2, 3, 4))
             + _const("i", np.asarray([[0, 0], [1, 2]], np.int32))
             + _const("s", np.asarray(7.5, np.float32))
             + _node("n", "Conv2D", ["x:0", "^f"], {
                 "strides": _attr_list_i([1, 2, 2, 1]), "padding": _attr_s(b"SAME"),
                 "eps": _attr_f(1e-3), "flag": _attr_b(True), "DstT": _attr_type(1), "axis": _attr_i(3)}))
    got, want = parse_graphdef(graph), jax_parse(graph)
    assert [(n.name, n.op, n.inputs) for n in got] == [(n.name, n.op, n.inputs) for n in want]
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(tensor_to_numpy(g.attrs["value"].tensor),
                                      tensor_to_numpy(w.attrs["value"].tensor))
    a, b = got[3].attrs, want[3].attrs
    assert a["strides"].list_i == b["strides"].list_i == [1, 2, 2, 1]
    assert (a["padding"].s, a["eps"].f, a["flag"].b, a["DstT"].type, a["axis"].i) == (
        b["padding"].s, b["eps"].f, b["flag"].b, b["DstT"].type, b["axis"].i) == (b"SAME", np.float32(1e-3),
                                                                                 True, 1, 3)


# ------------------------------------------------------- op families, vs JAX

def _bn_graph(scale_after: bool) -> bytes:
    rng = np.random.default_rng(3)
    stats = {"m": rng.standard_normal(6), "v": rng.uniform(0.5, 2.0, 6), "beta": rng.standard_normal(6),
             "gamma": rng.uniform(0.5, 1.5, 6)}
    return b"".join(_const(k, v.astype(np.float32)) for k, v in stats.items()) + _node(
        "bn", "BatchNormWithGlobalNormalization", ["x", "m", "v", "beta", "gamma"],
        {"variance_epsilon": _attr_f(1e-3), "scale_after_normalization": _attr_b(scale_after)})


def _bn_read_graph() -> bytes:
    """Batch norm with its statistics behind ``<name>/read`` Identity nodes,
    as frozen graphs keep them: computed per call, not folded."""
    graph = _bn_graph(True)
    for k in ("m", "v", "beta", "gamma"):
        graph += _node(f"{k}/read", "Identity", [k])
    return graph + _node("bn_read", "BatchNormWithGlobalNormalization",
                         ["x", "m/read", "v/read", "beta/read", "gamma/read"],
                         {"variance_epsilon": _attr_f(1e-3), "scale_after_normalization": _attr_b(True)})


def _resize_graph(h: int, w: int) -> bytes:
    return _const("size", np.asarray([h, w], np.int32)) + _node("out", "ResizeBilinear", ["x", "size"])


def _elementwise_graph() -> bytes:
    """Cast, ExpandDims, the pass-throughs, every unary and binary op."""
    g = _const("two", np.asarray(2.0, np.float32)) + _const("ax", np.asarray(1, np.int32))
    g += _node("id", "Identity", ["x"]) + _node("cn", "CheckNumerics", ["id"])
    g += _node("sg", "StopGradient", ["cn"]) + _node("pd", "PlaceholderWithDefault", ["sg"])
    g += _node("c", "Cast", ["pd"], {"DstT": _attr_type(1)})
    g += _node("e", "ExpandDims", ["c", "ax"])
    g += _node("sub", "Sub", ["e", "two"]) + _node("mul", "Mul", ["sub", "two"])
    g += _node("add", "Add", ["mul", "e"]) + _node("add2", "AddV2", ["add", "two"])
    g += _node("ba", "BiasAdd", ["add2", "two"]) + _node("dv", "Div", ["ba", "two"])
    g += _node("r", "Relu", ["dv"]) + _node("r6", "Relu6", ["dv"]) + _node("sig", "Sigmoid", ["dv"])
    g += _node("th", "Tanh", ["dv"]) + _node("ex", "Exp", ["th"]) + _node("ng", "Neg", ["sig"])
    g += _node("mx", "Maximum", ["r", "ng"]) + _node("mn", "Minimum", ["r6", "ex"])
    g += _node("sm", "Add", ["mx", "mn"]) + _node("out", "Softmax", ["sm"])
    return g


def _concat_matmul_graph(v2: bool, ta: bool, tb: bool) -> bytes:
    """Concat (axis input 0) or ConcatV2 (axis last) on axis 3, Reshape,
    Squeeze, MatMul with transposes."""
    w = _normal(5, (7, 12) if tb else (12, 7))
    g = _const("w", w) + _const("axis", np.asarray(3, np.int32))
    g += _const("shape", np.asarray([-1, 1, 1, 12], np.int32))
    ins = ["x", "x", "axis"] if v2 else ["axis", "x", "x"]
    g += _node("cat", "ConcatV2" if v2 else "Concat", ins)
    g += _node("rs", "Reshape", ["cat", "shape"])
    g += _node("sq", "Squeeze", ["rs"], {"squeeze_dims": _attr_list_i([1, 2])})
    if ta:
        g += _node("sqt", "Squeeze", ["rs"]) + _const("perm_shape", np.asarray([12, -1], np.int32))
        g += _node("a", "Reshape", ["sqt", "perm_shape"])
    g += _node("out", "MatMul", ["a" if ta else "sq", "w"],
               {"transpose_a": _attr_b(ta), "transpose_b": _attr_b(tb)})
    return g


def _shape_pack_fill_graph() -> bytes:
    g = _node("shp", "Shape", ["x"])
    g += _const("i0", np.asarray([0], np.int32)) + _const("i1", np.asarray([1], np.int32))
    g += _const("ones", np.asarray([1], np.int32)) + _const("two", np.asarray([2], np.int32))
    g += _node("d0", "StridedSlice", ["shp", "i0", "ones", "ones"], {"shrink_axis_mask": _attr_i(1)})
    g += _node("d1", "StridedSlice", ["shp", "i1", "two", "ones"], {"shrink_axis_mask": _attr_i(1)})
    g += _node("dims", "Pack", ["d0", "d1"], {"axis": _attr_i(0)})
    g += _const("seven", np.asarray(7.0, np.float32))
    return g + _node("out", "Fill", ["dims", "seven"])


def _mean_graph(keep: bool) -> bytes:
    return _const("ax", np.asarray([1, 2], np.int32)) + _node("out", "Mean", ["x", "ax"],
                                                                {"keep_dims": _attr_b(keep)})


X_NHWC = _normal(11, (2, 12, 14, 5))
X_ODD = _normal(12, (2, 11, 13, 5))

# name -> (graph, target, feeds, exact)
CASES = {
    **{f"conv_k{k}_s{s}_{p}_{h}x{w}": (_conv_graph(_normal(k * 10 + s, (k, k, 5, 7)) * 0.1, s, p), "conv",
                                       {"x": _normal(h + w, (2, h, w, 5))}, False)
       for k, s, p, (h, w) in [(1, 1, "VALID", (9, 9)), (3, 1, "SAME", (11, 13)), (3, 2, "SAME", (12, 14)),
                               (3, 2, "SAME", (11, 13)), (3, 2, "VALID", (15, 15)), (5, 1, "SAME", (8, 10)),
                               (7, 2, "SAME", (21, 21)), (2, 2, "SAME", (7, 9))]},
    **{f"{op}_k{k}_s{s}_{p}_{'odd' if x is X_ODD else 'even'}": (_pool_graph(op, k, s, p), "pool", {"x": x}, False)
       for op in ("MaxPool", "AvgPool") for k, s, p in [(3, 1, "SAME"), (3, 2, "SAME"), (3, 2, "VALID"),
                                                       (2, 2, "SAME"), (8, 1, "VALID")]
       for x in (X_NHWC, X_ODD)},
    "batchnorm_scale_after": (_bn_graph(True), "bn", {"x": _normal(13, (2, 5, 7, 6))}, False),
    "batchnorm_no_scale": (_bn_graph(False), "bn", {"x": _normal(13, (2, 5, 7, 6))}, False),
    "batchnorm_read_stats": (_bn_read_graph(), "bn_read", {"x": _normal(13, (2, 5, 7, 6))}, False),
    "resize_up": (_resize_graph(29, 31), "out", {"x": X_NHWC}, False),
    "resize_down": (_resize_graph(5, 6), "out", {"x": X_NHWC}, False),
    "elementwise": (_elementwise_graph(), "out", {"x": X_NHWC[..., 0]}, False),
    "concat_matmul": (_concat_matmul_graph(False, False, False), "out", {"x": _normal(2, (3, 1, 1, 6))}, False),
    "concatv2_matmul_tb": (_concat_matmul_graph(True, False, True), "out", {"x": _normal(3, (3, 1, 1, 6))}, False),
    "concat_matmul_ta": (_concat_matmul_graph(False, True, False), "out", {"x": _normal(4, (1, 1, 1, 6))}, False),
    "pad_slice_strided_mean_arith": (_extended_ops_graphdef(np.random.default_rng(0))[0], "out", {}, False),
    "shape_pack_fill": (_shape_pack_fill_graph(), "out", {"x": _normal(6, (3, 5))}, True),
    "mean_keep": (_mean_graph(True), "out", {"x": X_NHWC}, False),
    "mean_drop": (_mean_graph(False), "out", {"x": X_NHWC}, False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_executor_matches_jax(name):
    """Every op family of ``SUPPORTED_OPS`` through both executors on the
    same bytes: SAME and VALID at strides 1 and 2 with the asymmetric pads
    (even inputs at stride 2, even kernels), MaxPool's -inf padding and
    AvgPool's counts of real elements, both batch-norm settings, TF1's
    bilinear resize up and down."""
    graph, target, feeds, exact = CASES[name]
    got, want = _both(graph, target, feeds)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        tol = 1e-4 if name.startswith(("conv", "concat")) else 1e-5
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_every_supported_op_is_covered():
    """The cases above reach every op of ``SUPPORTED_OPS`` (the port's set
    is JAX's)."""
    assert port_inception.SUPPORTED_OPS == jax_inception.SUPPORTED_OPS
    ops = {n.op for graph, *_ in CASES.values() for n in parse_graphdef(graph)}
    assert port_inception.SUPPORTED_OPS <= ops


@pytest.mark.parametrize("hw,out", [((2, 2), (4, 4)), ((8, 8), (299, 299)), ((32, 32), (299, 299)),
                                    ((7, 5), (3, 11)), ((6, 6), (6, 6))])
def test_tf_resize_bilinear_matches_jax(hw, out):
    """TF1 ``align_corners=False``: ``src = dst * in / out``, not
    half-pixel centres; the JAX golden for 2x2 -> 4x4 rows [0, .5, 1, 1]."""
    import jax.numpy as jnp

    x = _normal(sum(hw), (2, *hw, 3)) * 100
    got = port_inception._tf_resize_bilinear(torch.from_numpy(x), *out).numpy()
    want = np.asarray(jax_inception._tf_resize_bilinear(jnp, jnp.asarray(x), *out))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    if hw == (2, 2):
        ramp = np.arange(4, dtype=np.float32).reshape(1, 2, 2, 1)
        rows = port_inception._tf_resize_bilinear(torch.from_numpy(ramp), 4, 4).numpy()
        np.testing.assert_allclose(rows[0, 0, :, 0], [0.0, 0.5, 1.0, 1.0], atol=1e-6)


def test_plan_holds_constants_on_the_device_once():
    """The plan is built once per (target, feeds): constants are not nodes of
    it, filters are stored once as channels-last OIHW."""
    graph, _ = _mini_inception_graphdef(np.random.default_rng(0))
    exe = port_inception._Executor(parse_graphdef(graph), "cpu")
    plan = exe.plan("pool_3", ("ExpandDims",))
    assert plan is exe.plan("pool_3", ("ExpandDims:0",))
    names = [name for name, _ in plan]
    assert names[0] == "resize" and names[-1] == "pool_3" and not any(
        exe.nodes[n].op == "Const" for n in names)
    w = exe._on_device[("conv/w", "filter")]
    assert w.shape == (6, 3, 3, 3) and w.is_contiguous(memory_format=torch.channels_last)


# -------------------------------------------------- the scorer, end to end

@pytest.fixture
def mini_pb(tmp_path):
    graph, _ = _mini_inception_graphdef(np.random.default_rng(0))
    pb = tmp_path / "classify_image_graph_def.pb"
    pb.write_bytes(graph)
    return pb


def test_mini_inception_score_and_fid_match_jax(mini_pb):
    """Predictions, IS and FID of the mini graph (its batch padded with the
    leading images, NCHW input) within 1e-5 relative of JAX's."""
    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 255, size=(43, 3, 8, 8)).astype(np.float32)
    port, jax_ = Inception2015(str(mini_pb), batch_size=8, device="cpu"), jax_inception.Inception2015(
        str(mini_pb), batch_size=8)
    (pf, pp), (jf, jp) = port.predictions(imgs), jax_.predictions(imgs)
    np.testing.assert_allclose(pf, jf, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pp, jp, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port.inception_score(imgs, splits=4), jax_.inception_score(imgs, splits=4),
                               rtol=1e-5)
    np.testing.assert_allclose(port.fid(imgs[:20], imgs[20:]), jax_.fid(imgs[:20], imgs[20:]), rtol=1e-5)
    assert port.fid(imgs, imgs) == pytest.approx(0.0, abs=1e-4)


def test_tgz_loading(tmp_path, mini_pb):
    tgz = tmp_path / "inception-2015-12-05.tgz"
    with tarfile.open(tgz, "w:gz") as tf_:
        tf_.add(mini_pb, arcname="classify_image_graph_def.pb")
    imgs = np.random.default_rng(2).uniform(20, 255, size=(4, 8, 8, 3)).astype(np.float32)
    got = Inception2015(str(tgz), batch_size=4, device="cpu").inception_score(imgs, splits=2)
    np.testing.assert_allclose(got, jax_inception.Inception2015(str(tgz), batch_size=4).inception_score(
        imgs, splits=2), rtol=1e-5)
    empty = tmp_path / "empty.tgz"
    with tarfile.open(empty, "w:gz"):
        pass
    with pytest.raises(FileNotFoundError, match="no classify_image_graph_def.pb"):
        Inception2015(str(empty), device="cpu")


def test_missing_file_error_is_actionable(monkeypatch, tmp_path):
    monkeypatch.delenv("CTGAN_INCEPTION_PB", raising=False)
    monkeypatch.setattr(port_inception, "_DEFAULT_LOCATIONS", ())
    with pytest.raises(FileNotFoundError, match="CTGAN_INCEPTION_PB"):
        Inception2015(str(tmp_path / "nope.pb"), device="cpu")


def test_find_inception_file_takes_a_path_then_the_environment(monkeypatch, tmp_path, mini_pb):
    monkeypatch.chdir(tmp_path)
    other = tmp_path / "other.pb"
    other.write_bytes(b"")
    monkeypatch.setenv("CTGAN_INCEPTION_PB", str(mini_pb))
    for path in (str(other), None, str(tmp_path / "missing.pb")):
        assert port_inception.find_inception_file(path) == jax_inception.find_inception_file(path)
    assert port_inception.find_inception_file(str(other)) == str(other)
    assert port_inception._DEFAULT_LOCATIONS == jax_inception._DEFAULT_LOCATIONS


def test_rejects_small_valued_images(mini_pb):
    inc = Inception2015(str(mini_pb), device="cpu")
    with pytest.raises(ValueError, match="0..255"):
        inc.inception_score(np.random.default_rng(0).uniform(-1, 1, size=(4, 8, 8, 3)))
    with pytest.raises(ValueError, match="expected"):
        inc.predictions(np.full((4, 8, 8), 100.0, np.float32))


def test_unsupported_census_matches_jax_and_the_plan_refuses():
    """``unsupported`` reports what JAX's reports; an unknown op on the path
    raises with its name when the plan is built, before anything runs."""
    graph = (_const("c", np.asarray(1.0, np.float32)) + _node("weird", "FusedFrobnicate", ["c"])
             + _node("mid", "Identity", ["weird"]) + _node("out", "Relu", ["mid"])
             + _node("dead", "AnotherUnknownOp", ["c"]))
    port = port_inception._Executor(parse_graphdef(graph), "cpu")
    jax_ = jax_inception._Executor(jax_parse(graph))
    for target, feeds in (("out", ()), ("out", ("mid",)), ("dead", ())):
        assert port.unsupported(target, feeds) == jax_.unsupported(target, feeds)
        assert {n.name for n in port.reachable(target, feeds)} == {n.name for n in jax_.reachable(target, feeds)}
    with pytest.raises(NotImplementedError, match="FusedFrobnicate"):
        port.plan("out")
    np.testing.assert_array_equal(port.run("out", {"mid": np.asarray([-1.0, 2.0], np.float32)}).numpy(), [0, 2])
    with pytest.raises(KeyError, match="not fed"):
        port_inception._Executor(parse_graphdef(_node("p", "Placeholder") + _node("o", "Relu", ["p"])),
                                 "cpu").run("o", {})


def test_an_inception_file_with_an_unknown_op_raises_when_loaded(tmp_path):
    """No fallback: the scorer refuses the graph at construction."""
    graph, _ = _mini_inception_graphdef(np.random.default_rng(0))
    pb = tmp_path / "bad.pb"
    pb.write_bytes(graph.replace(b"\x12\x04Relu", b"\x12\x04Relx"))
    with pytest.raises(NotImplementedError, match="Relx"):
        Inception2015(str(pb), device="cpu")


def test_strict_fp32_restores_the_callers_settings():
    old = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        with port_inception.strict_fp32():
            assert torch.backends.cudnn.allow_tf32 is False
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cudnn.allow_tf32 is True and torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cudnn.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


# ----------------------------------------------------------- pick_scorer

@pytest.mark.parametrize("channels", [3, 1])
def test_pick_scorer_routes_to_inception_2015(tmp_path, monkeypatch, mini_pb, channels, capsys):
    """With ``$CTGAN_INCEPTION_PB`` set both packages score with
    Inception-2015 (``comparable`` True), print the same line, and the flat
    adapter (1-channel images repeated to 3) gives JAX's scores."""
    monkeypatch.setenv("CTGAN_INCEPTION_PB", str(mini_pb))
    port = common.pick_scorer(channels, 8, str(tmp_path), device="cpu")
    port_line = capsys.readouterr().out
    jax_ = jax_common.pick_scorer(channels, 8, str(tmp_path))
    assert port.comparable is True and jax_.comparable is True
    assert port_line == capsys.readouterr().out
    flat = np.random.default_rng(3).integers(0, 256, size=(24, channels * 64)).astype(np.uint8)
    np.testing.assert_allclose(port.inception_score(flat, splits=3), jax_.inception_score(flat, splits=3),
                               rtol=1e-5)
    np.testing.assert_allclose(port.inception_score(torch.from_numpy(flat), splits=3),
                               jax_.inception_score(flat, splits=3), rtol=1e-5)
    np.testing.assert_allclose(port.fid(flat[:12], flat[12:]), jax_.fid(flat[:12], flat[12:]), rtol=1e-5)
    assert not (tmp_path / "scorer.npz").exists()


def test_pick_scorer_without_a_file_is_the_trained_scorer(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("CTGAN_INCEPTION_PB", raising=False)
    monkeypatch.setattr(port_inception, "_DEFAULT_LOCATIONS", ())
    scorer = common.pick_scorer(3, 32, str(tmp_path), device="cpu")
    assert isinstance(scorer, TrainedScorer) and scorer.comparable is False
