"""A frozen GraphDef with the published Inception-2015 architecture at full
width and seeded random weights, for holding an Inception-2015 scorer to
another without the real ``classify_image_graph_def.pb``.

The graph follows the real graph's chain: ``DecodeJpeg`` (a placeholder) ->
``Cast`` -> ``ExpandDims`` -> ``ResizeBilinear`` to 299x299 -> ``Sub`` 128
-> ``Mul`` 1/128; the stem ``conv`` ... ``pool_1``; the blocks ``mixed`` to
``mixed_10`` at the widths of arXiv:1512.00567 (288, 768, 1280 and 2048
channels at the grid changes); every conv ``<name>/Conv2D`` (HWIO filter
``<name>/conv2d_params``, no bias) -> ``<name>/batchnorm``
(BatchNormWithGlobalNormalization, variance_epsilon 0.001, without
``scale_after_normalization``) -> ``<name>`` (Relu); ``pool_3``, an 8x8
VALID AvgPool to 2048 features; ``pool_3/_reshape``;
``softmax/logits/MatMul`` with 2048x1008 weights; ``softmax/logits``
(BiasAdd) and ``softmax``.  94 convs, about 24 M weights.

Weights are drawn from ``np.random.default_rng(seed)``: filters at He scale
(normal, stdev ``sqrt(2 / fan_in)``), batch-norm statistics near the
identity, and logit weights at ``LOGIT_STDEV``, which makes the softmax of
these random features neither uniform nor one-hot.  ``blocks`` cuts the
depth (a reduced graph ends in a global average pool of its last block).

It imports NumPy only, with its own protobuf encoder.

    python tests/torch_inception_graph.py out.pb
"""

from __future__ import annotations

import struct
import sys

import numpy as np

__all__ = ["ALL_BLOCKS", "REDUCED_BLOCKS", "inception_graphdef", "write_inception_graph"]

ALL_BLOCKS = ("mixed", "mixed_1", "mixed_2", "mixed_3", "mixed_4", "mixed_5", "mixed_6", "mixed_7",
              "mixed_8", "mixed_9", "mixed_10")
REDUCED_BLOCKS = ("mixed", "mixed_3")  # one block of each of the first two kinds
N_CLASSES = 1008
LOGIT_STDEV = 0.03


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _ld(fnum: int, payload: bytes) -> bytes:  # a length-delimited field
    return _varint((fnum << 3) | 2) + _varint(len(payload)) + payload


def _tensor(arr: np.ndarray) -> bytes:
    dtype = {np.dtype("float32"): 1, np.dtype("int32"): 3}[arr.dtype]
    shape = b"".join(_ld(2, _varint(8) + _varint(d)) for d in arr.shape)
    return _varint(8) + _varint(dtype) + _ld(2, shape) + _ld(4, arr.tobytes())


def _attr_list_i(vals) -> bytes:
    return _ld(1, _ld(3, b"".join(_varint(v) for v in vals)))


def _attr_s(s: bytes) -> bytes:
    return _ld(2, s)


def _attr_f(f: float) -> bytes:
    return _varint((4 << 3) | 5) + struct.pack("<f", f)


def _attr_b(b: bool) -> bytes:
    return _varint(5 << 3) + _varint(int(b))


def _attr_type(t: int) -> bytes:
    return _varint(6 << 3) + _varint(t)


class _Graph:
    """Nodes in order, a running count of convs and weights, and the
    channels and spatial size of the latest tensor."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.parts: list[bytes] = []
        self.n_nodes = self.n_convs = self.n_weights = 0

    def node(self, name: str, op: str, inputs=(), attrs=None) -> str:
        body = _ld(1, name.encode()) + _ld(2, op.encode())
        body += b"".join(_ld(3, i.encode()) for i in inputs)
        body += b"".join(_ld(5, _ld(1, k.encode()) + _ld(2, v)) for k, v in (attrs or {}).items())
        self.parts.append(_ld(1, body))
        self.n_nodes += 1
        return name

    def const(self, name: str, arr: np.ndarray) -> str:
        if arr.dtype == np.float32:
            self.n_weights += arr.size
        return self.node(name, "Const", attrs={"value": _ld(8, _tensor(arr))})

    def conv(self, name: str, x: str, cin: int, cout: int, k, stride: int = 1, padding: str = "SAME") -> str:
        kh, kw = (k, k) if isinstance(k, int) else k
        w = self.rng.normal(0.0, np.sqrt(2.0 / (kh * kw * cin)), (kh, kw, cin, cout)).astype(np.float32)
        self.node(f"{name}/Conv2D", "Conv2D", [x, self.const(f"{name}/conv2d_params", w)], {
            "strides": _attr_list_i([1, stride, stride, 1]), "padding": _attr_s(padding.encode())})
        stats = [
            self.const(f"{name}/batchnorm/moving_mean", self.rng.normal(0.0, 0.1, cout).astype(np.float32)),
            self.const(f"{name}/batchnorm/moving_variance", self.rng.uniform(0.5, 1.5, cout).astype(np.float32)),
            self.const(f"{name}/batchnorm/beta", self.rng.normal(0.0, 0.1, cout).astype(np.float32)),
            self.const(f"{name}/batchnorm/gamma", self.rng.uniform(0.8, 1.2, cout).astype(np.float32)),
        ]
        self.node(f"{name}/batchnorm", "BatchNormWithGlobalNormalization", [f"{name}/Conv2D", *stats], {
            "variance_epsilon": _attr_f(0.001), "scale_after_normalization": _attr_b(False)})
        self.n_convs += 1
        return self.node(name, "Relu", [f"{name}/batchnorm"])

    def pool(self, name: str, op: str, x: str, k: int, stride: int, padding: str) -> str:
        return self.node(name, op, [x], {"ksize": _attr_list_i([1, k, k, 1]),
                                         "strides": _attr_list_i([1, stride, stride, 1]),
                                         "padding": _attr_s(padding.encode())})

    def concat(self, name: str, xs: list[str]) -> str:
        return self.node(name, "Concat", [self.const(f"{name}/concat_dim", np.asarray(3, np.int32)), *xs])


def _block_35(g: _Graph, b: str, x: str, cin: int, pool_ch: int) -> tuple[str, int]:
    """35x35: 1x1 64; 1x1 48 -> 5x5 64; 1x1 64 -> 3x3 96 -> 3x3 96; avg pool -> 1x1."""
    t0 = g.conv(f"{b}/conv", x, cin, 64, 1)
    t1 = g.conv(f"{b}/tower/conv_1", g.conv(f"{b}/tower/conv", x, cin, 48, 1), 48, 64, 5)
    t2 = g.conv(f"{b}/tower_1/conv", x, cin, 64, 1)
    t2 = g.conv(f"{b}/tower_1/conv_2", g.conv(f"{b}/tower_1/conv_1", t2, 64, 96, 3), 96, 96, 3)
    t3 = g.conv(f"{b}/tower_2/conv", g.pool(f"{b}/tower_2/pool", "AvgPool", x, 3, 1, "SAME"), cin, pool_ch, 1)
    return g.concat(f"{b}/join", [t0, t1, t2, t3]), 64 + 64 + 96 + pool_ch


def _reduce_35(g: _Graph, b: str, x: str, cin: int) -> tuple[str, int]:
    """35 -> 17: 3x3/2 384; 1x1 64 -> 3x3 96 -> 3x3/2 96; max pool 3x3/2."""
    t0 = g.conv(f"{b}/conv", x, cin, 384, 3, 2, "VALID")
    t1 = g.conv(f"{b}/tower/conv_1", g.conv(f"{b}/tower/conv", x, cin, 64, 1), 64, 96, 3)
    t1 = g.conv(f"{b}/tower/conv_2", t1, 96, 96, 3, 2, "VALID")
    t2 = g.pool(f"{b}/pool", "MaxPool", x, 3, 2, "VALID")
    return g.concat(f"{b}/join", [t0, t1, t2]), 384 + 96 + cin


def _block_17(g: _Graph, b: str, x: str, cin: int, mid: int) -> tuple[str, int]:
    """17x17 with factorised 7x7s of width ``mid``."""
    t0 = g.conv(f"{b}/conv", x, cin, 192, 1)
    t1 = g.conv(f"{b}/tower/conv", x, cin, mid, 1)
    t1 = g.conv(f"{b}/tower/conv_1", t1, mid, mid, (1, 7))
    t1 = g.conv(f"{b}/tower/conv_2", t1, mid, 192, (7, 1))
    t2 = g.conv(f"{b}/tower_1/conv", x, cin, mid, 1)
    for i, (k, cout) in enumerate((((7, 1), mid), ((1, 7), mid), ((7, 1), mid), ((1, 7), 192))):
        t2 = g.conv(f"{b}/tower_1/conv_{i + 1}", t2, mid, cout, k)
    t3 = g.conv(f"{b}/tower_2/conv", g.pool(f"{b}/tower_2/pool", "AvgPool", x, 3, 1, "SAME"), cin, 192, 1)
    return g.concat(f"{b}/join", [t0, t1, t2, t3]), 4 * 192


def _reduce_17(g: _Graph, b: str, x: str, cin: int) -> tuple[str, int]:
    """17 -> 8: 1x1 192 -> 3x3/2 320; 1x1 192 -> 1x7 -> 7x1 -> 3x3/2 192; max pool 3x3/2."""
    t0 = g.conv(f"{b}/tower/conv_1", g.conv(f"{b}/tower/conv", x, cin, 192, 1), 192, 320, 3, 2, "VALID")
    t1 = g.conv(f"{b}/tower_1/conv", x, cin, 192, 1)
    t1 = g.conv(f"{b}/tower_1/conv_1", t1, 192, 192, (1, 7))
    t1 = g.conv(f"{b}/tower_1/conv_2", t1, 192, 192, (7, 1))
    t1 = g.conv(f"{b}/tower_1/conv_3", t1, 192, 192, 3, 2, "VALID")
    t2 = g.pool(f"{b}/pool", "MaxPool", x, 3, 2, "VALID")
    return g.concat(f"{b}/join", [t0, t1, t2]), 320 + 192 + cin


def _block_8(g: _Graph, b: str, x: str, cin: int, pool_op: str) -> tuple[str, int]:
    """8x8: 1x1 320; 1x1 384 -> [1x3, 3x1] 384 each; 1x1 448 -> 3x3 384 -> [1x3, 3x1]; pool -> 1x1 192."""

    def split(name: str, y: str, c: int) -> str:
        return g.concat(f"{name}/mixed", [g.conv(f"{name}/mixed/conv", y, c, 384, (1, 3)),
                                          g.conv(f"{name}/mixed/conv_1", y, c, 384, (3, 1))])

    t0 = g.conv(f"{b}/conv", x, cin, 320, 1)
    t1 = split(f"{b}/tower", g.conv(f"{b}/tower/conv", x, cin, 384, 1), 384)
    t2 = g.conv(f"{b}/tower_1/conv_1", g.conv(f"{b}/tower_1/conv", x, cin, 448, 1), 448, 384, 3)
    t2 = split(f"{b}/tower_1", t2, 384)
    t3 = g.conv(f"{b}/tower_2/conv", g.pool(f"{b}/tower_2/pool", pool_op, x, 3, 1, "SAME"), cin, 192, 1)
    return g.concat(f"{b}/join", [t0, t1, t2, t3]), 320 + 768 + 768 + 192


def _build(seed: int, blocks) -> _Graph:
    g = _Graph(seed)
    g.node("DecodeJpeg", "Placeholder")
    g.node("Cast", "Cast", ["DecodeJpeg"], {"DstT": _attr_type(1)})
    x = g.node("ExpandDims", "ExpandDims", ["Cast", g.const("ExpandDims/dim", np.asarray(0, np.int32))])
    x = g.node("ResizeBilinear", "ResizeBilinear", [x, g.const("ResizeBilinear/size",
                                                                np.asarray([299, 299], np.int32))])
    x = g.node("Sub", "Sub", [x, g.const("Sub/y", np.asarray(128.0, np.float32))])
    x = g.node("Mul", "Mul", [x, g.const("Mul/y", np.asarray(1.0 / 128.0, np.float32))])
    x = g.conv("conv", x, 3, 32, 3, 2, "VALID")          # 149
    x = g.conv("conv_1", x, 32, 32, 3, 1, "VALID")       # 147
    x = g.conv("conv_2", x, 32, 64, 3)                   # 147
    x = g.pool("pool", "MaxPool", x, 3, 2, "VALID")      # 73
    x = g.conv("conv_3", x, 64, 80, 1, 1, "VALID")
    x = g.conv("conv_4", x, 80, 192, 3, 1, "VALID")      # 71
    x = g.pool("pool_1", "MaxPool", x, 3, 2, "VALID")    # 35
    c, size = 192, 35
    for b in blocks:
        if b in ("mixed", "mixed_1", "mixed_2"):
            x, c = _block_35(g, b, x, c, 32 if b == "mixed" else 64)
        elif b == "mixed_3":
            (x, c), size = _reduce_35(g, b, x, c), 17
        elif b in ("mixed_4", "mixed_5", "mixed_6", "mixed_7"):
            x, c = _block_17(g, b, x, c, {"mixed_4": 128, "mixed_7": 192}.get(b, 160))
        elif b == "mixed_8":
            (x, c), size = _reduce_17(g, b, x, c), 8
        else:  # mixed_9, mixed_10
            x, c = _block_8(g, b, x, c, "AvgPool" if b == "mixed_9" else "MaxPool")
    x = g.pool("pool_3", "AvgPool", x, size, 1, "VALID")
    x = g.node("pool_3/_reshape", "Reshape", [x, g.const("pool_3/_reshape/shape", np.asarray([-1, c], np.int32))])
    w = g.const("softmax/weights", g.rng.normal(0.0, LOGIT_STDEV, (c, N_CLASSES)).astype(np.float32))
    x = g.node("softmax/logits/MatMul", "MatMul", [x, w])
    x = g.node("softmax/logits", "BiasAdd", [x, g.const("softmax/biases", np.zeros(N_CLASSES, np.float32))])
    g.node("softmax", "Softmax", [x])
    return g


def inception_graphdef(seed: int = 0, blocks=ALL_BLOCKS) -> tuple[bytes, dict]:
    """(the serialised GraphDef, {"nodes", "convs", "weights"})."""
    g = _build(seed, blocks)
    return b"".join(g.parts), {"nodes": g.n_nodes, "convs": g.n_convs, "weights": g.n_weights}


def write_inception_graph(path, seed: int = 0, blocks=ALL_BLOCKS) -> dict:
    """Write the graph to ``path``; returns its counts and its bytes."""
    data, counts = inception_graphdef(seed, blocks)
    with open(path, "wb") as f:
        f.write(data)
    return {**counts, "bytes": len(data)}


if __name__ == "__main__":
    print(write_inception_graph(sys.argv[1]))
