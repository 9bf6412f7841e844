"""Inception-2015 Inception Score and FID from a user's frozen graph file
(counterpart of ``ctgan_tpu/eval/inception2015.py``).

The reference scores with the frozen Inception-2015 graph
``classify_image_graph_def.pb`` (from ``inception-2015-12-05.tgz``): float
images valued 0..255 are fed at the ``ExpandDims`` node, ``pool_3`` gives
2048 features, which are multiplied by the softmax weights (input 1 of
``softmax/logits/MatMul``, with no bias: the reference drops it), softmaxed
over 1008 classes, and the exp-KL is taken over 10 splits.  The file is not
in the repository and cannot be downloaded: the caller supplies it (the
``path`` argument, ``$CTGAN_INCEPTION_PB``, or the reference's cache
location ``/tmp/imagenet``).

:class:`_Executor` interprets the graph's op set with torch ops on an
explicit device.  Tensors keep TF's NHWC meaning, so every axis attribute
(``Concat``, ``Mean``, ``Reshape``, ``Squeeze``, the slices) means what it
means in TF; ``Conv2D`` and the pools run on the NCHW view
``x.permute(0, 3, 1, 2)``, whose storage is channels-last, so cuDNN takes it
without a copy, and the result is permuted back.  Filters are permuted from
HWIO to channels-last OIHW once, when the plan is built.  TF's SAME padding
is asymmetric at stride 2 (:func:`_same_pad`): where its two sides differ
the input is padded explicitly (``-inf`` for MaxPool), and AvgPool divides
by the count of real elements in each window, as TF does.  ResizeBilinear is
TF1's ``align_corners=False`` without half-pixel centres
(:func:`_tf_resize_bilinear`), not ``F.interpolate``'s.

Precision: the forward runs in fp32 with TF32 off for its convs and its
matmuls (:func:`strict_fp32`, which restores the caller's settings), since
the reference scored in fp32 and the inception score is the paper's number.
The app's bf16 precision policy does not reach it: the executor calls
``F.conv2d`` and ``torch.matmul`` itself.

The executor builds its plan once per target and set of fed nodes: the
nodes from the feed to the target in topological order, each a closure with
its constants already on the device and conv filters already permuted, so a
batch walks no node dictionary.  A reachable op outside
:data:`SUPPORTED_OPS` raises with its name when the plan is built, before
anything runs.
"""

from __future__ import annotations

import contextlib
import os
import tarfile
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from .graphdef import NodeDef, parse_graphdef, tensor_to_numpy
from .metrics import fid_from_features, inception_score_from_probs

__all__ = [
    "Inception2015", "SUPPORTED_OPS", "find_inception_file", "load_graphdef_bytes", "strict_fp32",
]

_DEFAULT_LOCATIONS = (
    "/tmp/imagenet/classify_image_graph_def.pb",  # the reference's cache path
    "/tmp/imagenet/inception-2015-12-05.tgz",
    "weights/classify_image_graph_def.pb",
    "weights/inception-2015-12-05.tgz",
)


def find_inception_file(path: str | None = None) -> str | None:
    """The Inception-2015 weight file (.pb or .tgz): ``path``, else
    ``$CTGAN_INCEPTION_PB``, else the first default location that exists
    (the last two relative to the working directory)."""
    cands = [path] if path else []
    env = os.environ.get("CTGAN_INCEPTION_PB")
    if env:
        cands.append(env)
    cands += list(_DEFAULT_LOCATIONS)
    return next((c for c in cands if c and os.path.exists(c)), None)


def load_graphdef_bytes(path: str) -> bytes:
    """A GraphDef read from a .pb, or extracted from the distribution .tgz."""
    if path.endswith((".tgz", ".tar.gz")):
        with tarfile.open(path, "r:gz") as tf_:
            for member in tf_.getmembers():
                if member.name.endswith("classify_image_graph_def.pb"):
                    f = tf_.extractfile(member)
                    if f is None:
                        break
                    return f.read()
        raise FileNotFoundError(f"no classify_image_graph_def.pb inside {path}")
    with open(path, "rb") as f:
        return f.read()


def _same_pad(in_size: int, stride: int, ksize: int) -> tuple[int, int]:
    """TF's SAME padding of one axis: (before, after); after takes the odd one."""
    out = -(-in_size // stride)
    pad = max(0, (out - 1) * stride + ksize - in_size)
    return pad // 2, pad - pad // 2


# Every op _Executor.run can evaluate (the JAX package's set).
SUPPORTED_OPS = frozenset({
    "Const", "Identity", "CheckNumerics", "StopGradient",
    "PlaceholderWithDefault", "ExpandDims", "Cast", "ResizeBilinear",
    "Sub", "Mul", "Add", "AddV2", "BiasAdd", "Conv2D",
    "BatchNormWithGlobalNormalization", "Relu", "Relu6", "MaxPool",
    "AvgPool", "Concat", "ConcatV2", "MatMul", "Reshape", "Squeeze",
    "Softmax", "Pad", "Shape", "StridedSlice", "Slice", "Pack", "Fill",
    "Rsqrt", "Sqrt", "Maximum", "Minimum", "RealDiv", "Div", "Neg",
    "Exp", "Tanh", "Sigmoid", "Mean",
})

_CAST = {1: torch.float32, 3: torch.int32, 4: torch.uint8, 9: torch.int64}
_UNARY = {
    "Relu": torch.relu, "Relu6": lambda x: torch.clamp(x, 0, 6), "Rsqrt": torch.rsqrt,
    "Sqrt": torch.sqrt, "Neg": torch.neg, "Exp": torch.exp, "Tanh": torch.tanh,
    "Sigmoid": torch.sigmoid, "Softmax": lambda x: torch.softmax(x, dim=-1),
}
_BINARY = {
    "Sub": torch.sub, "Mul": torch.mul, "Add": torch.add, "AddV2": torch.add, "BiasAdd": torch.add,
    "Maximum": torch.maximum, "Minimum": torch.minimum, "RealDiv": torch.div, "Div": torch.div,
}
_PASS = ("Identity", "CheckNumerics", "StopGradient", "PlaceholderWithDefault")

Step = Callable[[dict], object]


@contextlib.contextmanager
def strict_fp32():
    """fp32 convs and matmuls with TF32 off; the caller's settings return
    on exit."""
    old = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


def _host_ints(v) -> list[int]:
    """A shape-like value (array or tensor) as Python ints."""
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return [int(i) for i in np.asarray(v).ravel()]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _window_pads(x: torch.Tensor, ks, st, padding: str) -> tuple[int, int, int, int]:
    """(top, bottom, left, right) of an NHWC input under TF padding."""
    if padding != "SAME":
        return 0, 0, 0, 0
    return (*_same_pad(x.shape[1], st[0], ks[0]), *_same_pad(x.shape[2], st[1], ks[1]))


def _conv2d(x: torch.Tensor, w_oihw: torch.Tensor, strides, padding: str) -> torch.Tensor:
    t, b, l, r = _window_pads(x, w_oihw.shape[2:], strides, padding)
    xc = _nchw(x)
    if (t, l) == (b, r):
        return _nhwc(F.conv2d(xc, w_oihw, stride=strides, padding=(t, l)))
    return _nhwc(F.conv2d(F.pad(xc, (l, r, t, b)), w_oihw, stride=strides))


def _max_pool(x: torch.Tensor, ks, st, padding: str) -> torch.Tensor:
    t, b, l, r = _window_pads(x, ks, st, padding)
    xc = _nchw(x)
    if (t, l) == (b, r):
        return _nhwc(F.max_pool2d(xc, ks, st, padding=(t, l)))
    return _nhwc(F.max_pool2d(F.pad(xc, (l, r, t, b), value=float("-inf")), ks, st))


def _avg_pool(x: torch.Tensor, ks, st, padding: str) -> torch.Tensor:
    """The mean over each window's real elements (TF leaves padding out of
    the count): PyTorch's ``count_include_pad=False`` where the padding is
    symmetric, else window sums over the zero-padded input divided by the
    windows' counts of real elements."""
    t, b, l, r = _window_pads(x, ks, st, padding)
    xc = _nchw(x)
    if (t, l) == (b, r):
        return _nhwc(F.avg_pool2d(xc, ks, st, padding=(t, l), count_include_pad=False))
    sums = F.avg_pool2d(F.pad(xc, (l, r, t, b)), ks, st, divisor_override=1)
    ones = torch.ones((1, 1, *xc.shape[2:]), dtype=x.dtype, device=x.device)
    counts = F.avg_pool2d(F.pad(ones, (l, r, t, b)), ks, st, divisor_override=1)
    return _nhwc(sums / counts)


def _axis_weights(in_size: int, out_size: int):
    """TF1's source rows of a resize: ``src = dst * in / out`` (no
    half-pixel centres), its floor, the next row clamped, and the fraction."""
    src = np.arange(out_size, dtype=np.float64) * (in_size / out_size)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, (src - lo).astype(np.float32)


def _tf_resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """TF1 ResizeBilinear (``align_corners=False``) of NHWC ``x``, in the
    JAX package's gather form and order of operations."""
    _, in_h, in_w, _ = x.shape
    if (in_h, in_w) == (out_h, out_w):
        return x
    ylo, yhi, yf = (torch.from_numpy(a).to(x.device) for a in _axis_weights(in_h, out_h))
    xlo, xhi, xf = (torch.from_numpy(a).to(x.device) for a in _axis_weights(in_w, out_w))
    yf = yf[None, :, None, None]
    xf = xf[None, None, :, None]
    top_rows, bot_rows = x[:, ylo], x[:, yhi]
    top = top_rows[:, :, xlo] * (1 - xf) + top_rows[:, :, xhi] * xf
    bot = bot_rows[:, :, xlo] * (1 - xf) + bot_rows[:, :, xhi] * xf
    return top * (1 - yf) + bot * yf


class _Executor:
    """Interprets the frozen graph's op set with torch ops on ``device``.

    ``run(target, feeds)`` evaluates node ``target`` with ``feeds``
    overriding named nodes' outputs (the reference feeds
    ``ExpandDims:0``), through the plan of :meth:`plan`.
    """

    def __init__(self, nodes: list[NodeDef], device="cuda"):
        self.nodes = {n.name: n for n in nodes}
        self.consts: dict[str, np.ndarray] = {
            n.name: tensor_to_numpy(n.attrs["value"].tensor) for n in nodes if n.op == "Const"
        }
        self.device = torch.device(device)
        self._on_device: dict[tuple[str, str], torch.Tensor] = {}
        self._plans: dict[tuple[str, frozenset], list[tuple[str, Step]]] = {}

    def reachable(self, target: str, feeds: tuple = ()) -> list[NodeDef]:
        """Every node evaluated for ``target`` with ``feeds`` overridden:
        the execution frontier (fed nodes' inputs are not visited)."""
        fed = {self._base(f) for f in feeds}
        seen: dict[str, NodeDef] = {}
        stack = [self._base(target)]
        while stack:
            name = stack.pop()
            if name in seen or name in fed:
                continue
            node = self.nodes[name]
            seen[name] = node
            stack.extend(self._base(i) for i in node.inputs)
        return list(seen.values())

    def unsupported(self, target: str, feeds: tuple = ()) -> dict[str, list[str]]:
        """op -> node names of the reachable ops outside SUPPORTED_OPS."""
        gaps: dict[str, list[str]] = {}
        for n in self.reachable(target, feeds):
            if n.op not in SUPPORTED_OPS:
                gaps.setdefault(n.op, []).append(n.name)
        return gaps

    def const(self, name: str) -> np.ndarray:
        return self.consts[self._base(name)]

    @staticmethod
    def _base(ref: str) -> str:
        return ref.lstrip("^").split(":")[0]

    def _device_const(self, name: str, kind: str = "value") -> torch.Tensor:
        """Const ``name`` on the device, once: as it is (float64 as
        float32, as JAX stores it), or (``kind="filter"``) an HWIO filter as
        channels-last OIHW."""
        key = (name, kind)
        if key not in self._on_device:
            arr = np.array(self.consts[name])
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            t = torch.from_numpy(arr).to(self.device)
            if kind == "filter":
                t = t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            self._on_device[key] = t
        return self._on_device[key]

    def _order(self, target: str, fed: frozenset) -> list[NodeDef]:
        """The nodes ``target`` needs, inputs first, leaving out fed nodes
        and Const nodes (their consumers hold them)."""
        order, done = [], set(fed)
        stack = [(self._base(target), False)]
        while stack:
            name, expanded = stack.pop()
            if name in done:
                continue
            node = self.nodes[name]
            if expanded or (node.op == "Const" and name != self._base(target)):
                done.add(name)
                if node.op != "Const" or name == self._base(target):
                    order.append(node)
                continue
            stack.append((name, True))
            stack.extend((self._base(i), False) for i in reversed(node.inputs) if self._base(i) not in done)
        return order

    def plan(self, target: str, feeds: tuple = ()) -> list[tuple[str, Step]]:
        """``[(node name, step(env) -> value)]`` for ``target`` given the
        fed node names, built once.  Raises ``NotImplementedError`` naming
        the first reachable op outside SUPPORTED_OPS."""
        fed = frozenset(self._base(f) for f in feeds)
        key = (self._base(target), fed)
        if key not in self._plans:
            self._plans[key] = [(n.name, self._compile(n, fed)) for n in self._order(target, fed)]
        return self._plans[key]

    def run(self, target: str, feeds: dict[str, object]):
        """Evaluate node ``target`` with ``feeds`` overriding named nodes'
        outputs; array feeds go to the device."""
        env = {self._base(k): torch.as_tensor(v, device=self.device) for k, v in feeds.items()}
        for name, step in self.plan(target, tuple(env)):
            env[name] = step(env)
        return env[self._base(target)]

    def _compile(self, node: NodeDef, fed: frozenset) -> Step:
        op, name = node.op, node.name

        def attr(key, default=None):
            a = node.attrs.get(key)
            return a if a is not None else default

        def arg(i: int) -> Step:
            ref = self._base(node.inputs[i])
            if ref not in fed and self.nodes[ref].op == "Const":
                t = self._device_const(ref)
                return lambda env: t
            return lambda env: env[ref]

        def static(i: int) -> np.ndarray:
            return np.asarray(self.const(node.inputs[i]))

        if op not in SUPPORTED_OPS:
            if op == "Placeholder":
                raise KeyError(f"placeholder {name!r} not fed (feeds: bind its consumer)")
            raise NotImplementedError(f"GraphDef op {op!r} (node {name!r}) not implemented")
        if op == "Const":
            t = self._device_const(name)
            return lambda env: t
        if op in _PASS:
            return arg(0)
        if op in _UNARY:
            fn, x = _UNARY[op], arg(0)
            return lambda env: fn(x(env))
        if op in _BINARY:
            fn, a, b = _BINARY[op], arg(0), arg(1)
            return lambda env: fn(a(env), b(env))
        if op == "ExpandDims":
            x, dim = arg(0), int(static(1))
            return lambda env: x(env).unsqueeze(dim)
        if op == "Cast":
            x, dtype = arg(0), _CAST[attr("DstT").type]
            return lambda env: x(env).to(dtype)
        if op == "ResizeBilinear":
            x, (h, w) = arg(0), _host_ints(static(1))
            return lambda env: _tf_resize_bilinear(x(env), h, w)
        if op == "Conv2D":
            x = arg(0)
            w = self._device_const(self._base(node.inputs[1]), "filter")
            strides, padding = attr("strides").list_i[1:3], attr("padding").s.decode()
            return lambda env: _conv2d(x(env), w, strides, padding)
        if op in ("MaxPool", "AvgPool"):
            x, pool = arg(0), _max_pool if op == "MaxPool" else _avg_pool
            ks, st = attr("ksize").list_i[1:3], attr("strides").list_i[1:3]
            padding = attr("padding").s.decode()
            return lambda env: pool(x(env), ks, st, padding)
        if op == "BatchNormWithGlobalNormalization":
            return self._batch_norm(node, fed, arg, attr)
        if op == "Pad":
            x, pads = arg(0), static(1).astype(int)
            flat = [int(p) for pair in pads[::-1] for p in pair]
            return lambda env: F.pad(x(env), flat)
        if op == "Shape":
            x = arg(0)
            return lambda env: torch.tensor(tuple(x(env).shape), dtype=torch.int32)
        if op == "Fill":
            dims, value = arg(0), arg(1)

            def fill(env):
                v = torch.as_tensor(value(env))
                return torch.full(_host_ints(dims(env)), v.item(), dtype=v.dtype, device=self.device)

            return fill
        if op == "Pack":
            axis, xs = (attr("axis").i if attr("axis") is not None else 0), [arg(i) for i in range(len(node.inputs))]
            return lambda env: torch.stack([torch.as_tensor(x(env)) for x in xs], dim=axis)
        if op == "Slice":
            x, begin, size = arg(0), static(1).astype(int), static(2).astype(int)

            def slice_(env):
                v = x(env)
                return v[tuple(slice(b, v.shape[d] if s == -1 else b + s)
                               for d, (b, s) in enumerate(zip(begin, size)))]

            return slice_
        if op == "StridedSlice":
            return self._strided_slice(node, arg, static, attr)
        if op == "Mean":
            x, axes = arg(0), tuple(static(1).ravel().astype(int).tolist())
            keep = bool(attr("keep_dims").b) if attr("keep_dims") is not None else False
            return lambda env: x(env).mean(dim=axes, keepdim=keep)
        if op in ("Concat", "ConcatV2"):
            if op == "Concat":  # the axis is input 0
                axis, xs = int(static(0)), [arg(i) for i in range(1, len(node.inputs))]
            else:  # the axis is the last input
                axis, xs = int(static(len(node.inputs) - 1)), [arg(i) for i in range(len(node.inputs) - 1)]
            return lambda env: torch.cat([x(env) for x in xs], dim=axis)
        if op == "MatMul":
            a, b = arg(0), arg(1)
            ta = bool(attr("transpose_a") and attr("transpose_a").b)
            tb = bool(attr("transpose_b") and attr("transpose_b").b)
            return lambda env: torch.matmul(a(env).T if ta else a(env), b(env).T if tb else b(env))
        if op == "Reshape":
            x, shape = arg(0), [int(s) for s in static(1).ravel()]
            return lambda env: x(env).reshape(shape)
        # Squeeze: the last op of SUPPORTED_OPS
        x, dims = arg(0), attr("squeeze_dims")
        if dims and dims.list_i:
            axes = tuple(dims.list_i)
            return lambda env: torch.squeeze(x(env), dim=axes)
        return lambda env: torch.squeeze(x(env))

    def _batch_norm(self, node: NodeDef, fed: frozenset, arg, attr) -> Step:
        """``t * inv + (beta - m * inv)`` with ``inv = rsqrt(v + eps)``,
        times ``gamma`` only under ``scale_after_normalization``.  With
        constant statistics (a frozen graph) ``inv`` and the shift are
        computed once, on the device."""
        x, m, v, beta, gamma = (arg(i) for i in range(5))
        eps = attr("variance_epsilon").f
        scale_after = attr("scale_after_normalization")
        scale = scale_after is not None and scale_after.b

        def affine(env):
            inv = torch.rsqrt(v(env) + eps)
            if scale:
                inv = inv * gamma(env)
            return inv, beta(env) - m(env) * inv

        stats = [self._base(i) for i in node.inputs[1:5]]
        if all(s in self.consts and s not in fed for s in stats):
            inv, shift = affine({})
            return lambda env: x(env) * inv + shift

        def bn(env):
            inv, shift = affine(env)
            return x(env) * inv + shift

        return bn

    def _strided_slice(self, node: NodeDef, arg, static, attr) -> Step:
        """Constant begin/end/strides with begin, end and shrink masks, the
        subset frozen inference graphs use (no ellipsis or new-axis masks)."""
        x = arg(0)
        begin, end, strides = (static(i).astype(int) for i in (1, 2, 3))
        bm, em, sm = ((attr(k).i if attr(k) is not None else 0)
                      for k in ("begin_mask", "end_mask", "shrink_axis_mask"))
        idx = []
        for d in range(len(begin)):
            if sm & (1 << d):
                idx.append(int(begin[d]))
                continue
            b = None if bm & (1 << d) else int(begin[d])
            e = None if em & (1 << d) else int(end[d])
            idx.append(slice(b, e, int(strides[d])))
        idx = tuple(idx)
        return lambda env: x(env)[idx]


class Inception2015:
    """Inception-2015 scorer over a user-supplied frozen graph file, on
    ``device``.

    >>> inc = Inception2015("/tmp/imagenet/inception-2015-12-05.tgz")
    >>> mean, std = inc.inception_score(images)   # 0..255-valued, NHWC or NCHW
    """

    FEED = "ExpandDims"        # the reference feeds 'ExpandDims:0'
    POOL = "pool_3"            # 2048 features
    LOGITS_W = "softmax/logits/MatMul"  # the weights are its input 1

    def __init__(self, path: str | None = None, batch_size: int = 100, device="cuda"):
        resolved = find_inception_file(path)
        if resolved is None:
            raise FileNotFoundError(
                "Inception-2015 weights not found. Supply "
                "classify_image_graph_def.pb or inception-2015-12-05.tgz via "
                "the path argument, $CTGAN_INCEPTION_PB, or /tmp/imagenet/. "
                "(Download: http://download.tensorflow.org/models/image/"
                "imagenet/inception-2015-12-05.tgz)"
            )
        self.path = resolved
        self.device = torch.device(device)
        self.exe = _Executor(parse_graphdef(load_graphdef_bytes(resolved)), self.device)
        self.batch_size = batch_size
        self.w = np.asarray(self.exe.const(self.exe.nodes[self.LOGITS_W].inputs[1]))
        self._w = torch.from_numpy(np.array(self.w, np.float32)).to(self.device)
        self.exe.plan(self.POOL, (self.FEED,))  # constants to the device; unknown ops raise here

    def _forward(self, batch: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(pool_3 features, softmax) of an NHWC fp32 batch on the device."""
        with torch.no_grad(), strict_fp32():
            pool3 = self.exe.run(self.POOL, {self.FEED: batch})
            feats = pool3.reshape(pool3.shape[0], -1)
            return feats, torch.softmax(feats @ self._w, dim=-1)

    def _to_nhwc(self, images) -> torch.Tensor:
        """Images (array or tensor, NHWC or NCHW) as fp32 NHWC on the device."""
        x = images if isinstance(images, torch.Tensor) else torch.from_numpy(np.asarray(images))
        x = x.to(self.device, torch.float32)
        if x.ndim != 4:
            raise ValueError(f"expected [N,H,W,3] or [N,3,H,W], got {tuple(x.shape)}")
        if x.shape[1] == 3 and x.shape[-1] != 3:
            x = x.permute(0, 2, 3, 1)
        if float(x.max()) <= 10.0:
            raise ValueError("images must be valued 0..255 (reference :29)")
        return x

    def predictions(self, images) -> tuple[np.ndarray, np.ndarray]:
        """(pool_3 features [N, 2048], softmax [N, 1008]) in batches of
        ``batch_size``, the last padded with the leading images."""
        x = self._to_nhwc(images)
        bs = self.batch_size
        pad = (-len(x)) % bs
        padded = torch.cat([x, x[:pad]]) if pad else x
        outs = [self._forward(padded[i : i + bs]) for i in range(0, len(padded), bs)]
        feats = torch.cat([f for f, _ in outs])[: len(x)]
        preds = torch.cat([p for _, p in outs])[: len(x)]
        return feats.cpu().numpy(), preds.cpu().numpy()

    def inception_score(self, images, splits: int = 10) -> tuple[float, float]:
        """The reference protocol: exp-KL of the softmax over ``splits``
        parts, mean and standard deviation."""
        _, preds = self.predictions(images)
        return inception_score_from_probs(preds, splits=splits)

    def fid(self, real_images, fake_images) -> float:
        rf, _ = self.predictions(real_images)
        ff, _ = self.predictions(fake_images)
        return fid_from_features(rf, ff)
