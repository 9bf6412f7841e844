"""Minimal TensorFlow GraphDef reader, pure Python (own copy of
``ctgan_tpu/eval/graphdef.py``; the port imports nothing of the JAX package).

The Inception-2015 score reads the frozen graph
``classify_image_graph_def.pb``.  A frozen GraphDef is ``repeated NodeDef``
in protobuf's wire format, every weight a Const node's TensorProto, so this
module decodes the wire format directly and needs no TensorFlow;
``ctgan_tpu_torch.eval.inception2015`` then runs the graph with torch ops.

Wire-format field numbers (tensorflow/core/framework/*.proto):
  GraphDef:    node=1
  NodeDef:     name=1, op=2, input=3, device=4, attr=5 (map<string,AttrValue>)
  AttrValue:   list=1, s=2, i=3, f=4, b=5, type=6, shape=7, tensor=8
  TensorProto: dtype=1, tensor_shape=2, tensor_content=4, float_val=5,
               double_val=6, int_val=7, string_val=8, int64_val=10, bool_val=11
  TensorShapeProto: dim=2 (Dim: size=1, name=2), unknown_rank=3
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any

import numpy as np

__all__ = ["AttrVal", "NodeDef", "parse_graphdef", "tensor_to_numpy"]

# DataType enum values we care about (types.proto)
_DTYPES = {
    1: np.float32,
    2: np.float64,
    3: np.int32,
    4: np.uint8,
    5: np.int16,
    6: np.int8,
    9: np.int64,
    10: np.bool_,
}


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer.

    value: int for varint(0)/fixed64(1)/fixed32(5), bytes for length-
    delimited(2).
    """
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wt == 5:
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:  # groups (3,4) don't appear in TF protos
            raise ValueError(f"unsupported wire type {wt}")
        yield fnum, wt, val


def _packed_or_single(wt: int, val: Any, fmt: str, size: int) -> list:
    """proto3 repeated scalars may arrive packed (wt=2) or one-per-field."""
    if wt == 2:
        return list(struct.unpack(f"<{len(val) // size}{fmt}", val))
    if fmt == "f":
        return [struct.unpack("<f", struct.pack("<I", val))[0]]
    if fmt == "d":
        return [struct.unpack("<d", struct.pack("<Q", val))[0]]
    return [val]


def _packed_varints(wt: int, val: Any) -> list[int]:
    if wt == 0:
        return [val]
    out, pos = [], 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(v)
    return out


@dataclass
class TensorShape:
    dims: list[int] = field(default_factory=list)
    unknown_rank: bool = False


def _parse_shape(buf: bytes) -> TensorShape:
    shape = TensorShape()
    for fnum, wt, val in _fields(buf):
        if fnum == 2:  # dim
            for f2, _w2, v2 in _fields(val):
                if f2 == 1:  # size (int64; -1 = unknown)
                    size = v2 - (1 << 64) if v2 >= (1 << 63) else v2
                    shape.dims.append(size)
        elif fnum == 3:
            shape.unknown_rank = bool(val)
    return shape


@dataclass
class TensorValue:
    dtype: Any = None
    shape: TensorShape = field(default_factory=TensorShape)
    content: bytes = b""
    float_val: list = field(default_factory=list)
    double_val: list = field(default_factory=list)
    int_val: list = field(default_factory=list)
    int64_val: list = field(default_factory=list)
    bool_val: list = field(default_factory=list)
    string_val: list = field(default_factory=list)


def _parse_tensor(buf: bytes) -> TensorValue:
    t = TensorValue()
    for fnum, wt, val in _fields(buf):
        if fnum == 1:
            t.dtype = _DTYPES.get(val)
        elif fnum == 2:
            t.shape = _parse_shape(val)
        elif fnum == 4:
            t.content = val
        elif fnum == 5:
            t.float_val += _packed_or_single(wt, val, "f", 4)
        elif fnum == 6:
            t.double_val += _packed_or_single(wt, val, "d", 8)
        elif fnum == 7:
            t.int_val += _packed_varints(wt, val)
        elif fnum == 8:
            t.string_val.append(val)
        elif fnum == 10:
            t.int64_val += _packed_varints(wt, val)
        elif fnum == 11:
            t.bool_val += _packed_varints(wt, val)
    return t


def tensor_to_numpy(t: TensorValue) -> np.ndarray:
    dims = t.shape.dims
    dtype = t.dtype or np.float32
    if t.content:
        arr = np.frombuffer(t.content, dtype=dtype)
    elif t.float_val:
        arr = np.asarray(t.float_val, np.float32)
    elif t.double_val:
        arr = np.asarray(t.double_val, np.float64)
    elif t.int64_val:
        arr = np.asarray(t.int64_val, np.int64)
    elif t.int_val:
        arr = np.asarray(t.int_val, dtype if dtype != np.bool_ else np.int32)
    elif t.bool_val:
        arr = np.asarray(t.bool_val, np.bool_)
    elif t.string_val:
        return np.asarray(t.string_val, object)
    else:
        arr = np.zeros(0, dtype)
    n = int(np.prod(dims)) if dims else arr.size
    if arr.size == 1 and n > 1:  # splat-encoded constant
        arr = np.full(n, arr[0], arr.dtype)
    return arr.reshape(dims) if dims else (arr[0] if arr.size == 1 else arr)


@dataclass
class AttrVal:
    s: bytes | None = None
    i: int | None = None
    f: float | None = None
    b: bool | None = None
    type: int | None = None
    shape: TensorShape | None = None
    tensor: TensorValue | None = None
    list_i: list = field(default_factory=list)
    list_s: list = field(default_factory=list)
    list_f: list = field(default_factory=list)


def _parse_attrvalue(buf: bytes) -> AttrVal:
    a = AttrVal()
    for fnum, wt, val in _fields(buf):
        if fnum == 1:  # ListValue
            for f2, w2, v2 in _fields(val):
                if f2 == 2:
                    a.list_s.append(v2)
                elif f2 == 3:
                    a.list_i += _packed_varints(w2, v2)
                elif f2 == 4:
                    a.list_f += _packed_or_single(w2, v2, "f", 4)
        elif fnum == 2:
            a.s = val
        elif fnum == 3:
            a.i = val - (1 << 64) if val >= (1 << 63) else val
        elif fnum == 4:
            a.f = struct.unpack("<f", struct.pack("<I", val))[0]
        elif fnum == 5:
            a.b = bool(val)
        elif fnum == 6:
            a.type = val
        elif fnum == 7:
            a.shape = _parse_shape(val)
        elif fnum == 8:
            a.tensor = _parse_tensor(val)
    return a


@dataclass
class NodeDef:
    name: str = ""
    op: str = ""
    inputs: list[str] = field(default_factory=list)
    attrs: dict[str, AttrVal] = field(default_factory=dict)


def _parse_node(buf: bytes) -> NodeDef:
    node = NodeDef()
    for fnum, _wt, val in _fields(buf):
        if fnum == 1:
            node.name = val.decode("utf-8")
        elif fnum == 2:
            node.op = val.decode("utf-8")
        elif fnum == 3:
            node.inputs.append(val.decode("utf-8"))
        elif fnum == 5:  # map entry {key=1, value=2}
            key, attr = None, None
            for f2, _w2, v2 in _fields(val):
                if f2 == 1:
                    key = v2.decode("utf-8")
                elif f2 == 2:
                    attr = _parse_attrvalue(v2)
            if key is not None:
                node.attrs[key] = attr
    return node


def parse_graphdef(data: bytes) -> list[NodeDef]:
    """Parse a serialized GraphDef into a node list (graph order)."""
    nodes = []
    for fnum, _wt, val in _fields(data):
        if fnum == 1:
            nodes.append(_parse_node(val))
    return nodes
