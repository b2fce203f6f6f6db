"""The quantized op zoo + DAG graph executor (a copy of
tfhe_tpu/ml/quantized_ops.py; host numpy over ml/quantized_module).

Round 1 covered ~6 op kinds; the reference implements 54 quantized ONNX
op classes executed over a graph (reference:
ml/concrete-ml/src/concrete/ml/quantization/quantized_ops.py;
quantized_module.py's graph evaluation). This module brings the zoo to
parity for the families that matter in practice:

- univariate nonlinearities (fused into TLUs between linear segments:
  the reference's quantized_module_passes.py strategy): Sigmoid,
  HardSigmoid, Relu/PRelu/LeakyRelu, HardSwish, Elu/Selu/Celu, Clip,
  Round/Floor/Sign/Abs/Neg/Not/Erf/Exp/Log/Pow, Tanh, Softplus
- mixing ops: Add, Sub, Mul, Div, MatMul/Gemm (GLWE backend), Conv,
  ReduceSum, BatchNormalization (folds to affine)
- comparisons + selection: Greater(OrEqual), Less(OrEqual), Equal,
  Or, Where
- structure: Reshape, Transpose, Flatten, Squeeze, Unsqueeze, Concat,
  Pad, Expand, Identity, Cast
- pooling: AvgPool (quantized_module), MaxPool, Unfold

`QuantizedGraphModule` executes a DAG of (op, input_ids) nodes -- the
multi-input generalization of QuantizedModule's pipeline (residual
connections, Where over three tensors, binary ops between branches).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

from tfhe_tpu_torch.ml.common import FheMode
from tfhe_tpu_torch.ml.quantization import UniformQuantizer
from tfhe_tpu_torch.ml.quantized_module import (
    QuantizedAvgPool,
    QuantizedConv,
    QuantizedFlatten,
    QuantizedGemm,
    QuantizedOp,
    QuantizedTLU,
)

__all__ = ["QuantizedGraphModule", "UNIVARIATE_OPS"]


# -- univariate TLU family ---------------------------------------------------


def _erf(x):
    v = np.vectorize(math.erf)(np.asarray(x, np.float64))
    return v


UNIVARIATE_OPS: dict[str, Callable] = {
    # reference quantized_ops.py classes :57-:129, :693-:723, :2217-:2522
    "Sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "HardSigmoid": lambda x: np.clip(x / 6.0 + 0.5, 0.0, 1.0),
    "Relu": lambda x: np.maximum(x, 0.0),
    "LeakyRelu": lambda x: np.where(x > 0, x, 0.01 * x),
    "HardSwish": lambda x: x * np.clip(x / 6.0 + 0.5, 0.0, 1.0),
    "Elu": lambda x: np.where(x > 0, x, np.exp(np.minimum(x, 0.0)) - 1.0),
    "Selu": lambda x: 1.0507 * np.where(
        x > 0, x, 1.67326 * (np.exp(np.minimum(x, 0.0)) - 1.0)
    ),
    "Celu": lambda x: np.maximum(x, 0.0) + np.minimum(
        0.0, np.exp(np.minimum(x, 0.0)) - 1.0
    ),
    "Tanh": np.tanh,
    "Softplus": lambda x: np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0.0),
    "Exp": lambda x: np.exp(np.minimum(x, 60.0)),
    "Log": lambda x: np.log(np.maximum(x, 1e-12)),
    "Abs": np.abs,
    "Neg": lambda x: -x,
    "Sign": np.sign,
    "Round": np.round,
    "Floor": np.floor,
    "Erf": _erf,
    "Not": lambda x: 1.0 - (np.asarray(x) != 0).astype(np.float64),
    "Identity": lambda x: x,
    # reference quantized_ops.py trig/analytic family (:2217-:2522)
    "Sqrt": lambda x: np.sqrt(np.maximum(x, 0.0)),
    "Reciprocal": lambda x: 1.0 / np.where(np.abs(x) < 1e-12, 1e-12, x),
    "Sin": np.sin,
    "Cos": np.cos,
    "Tan": lambda x: np.tan(np.clip(x, -1.55, 1.55)),
    "Sinh": lambda x: np.sinh(np.clip(x, -60.0, 60.0)),
    "Cosh": lambda x: np.cosh(np.clip(x, -60.0, 60.0)),
    "Asin": lambda x: np.arcsin(np.clip(x, -1.0, 1.0)),
    "Acos": lambda x: np.arccos(np.clip(x, -1.0, 1.0)),
    "Atan": np.arctan,
    "Asinh": np.arcsinh,
    "Acosh": lambda x: np.arccosh(np.maximum(x, 1.0)),
    "Atanh": lambda x: np.arctanh(np.clip(x, -0.999999, 0.999999)),
}


def make_univariate(name: str, n_bits: int = 8, **kw) -> QuantizedTLU:
    """One TLU op from the zoo table; PRelu/Clip/Pow parametrize."""
    if name == "PRelu":
        slope = float(kw.get("slope", 0.25))
        fn = lambda x: np.where(x > 0, x, slope * x)
    elif name == "Clip":
        lo, hi = float(kw.get("min", -1.0)), float(kw.get("max", 1.0))
        fn = lambda x: np.clip(x, lo, hi)
    elif name == "Pow":
        p = float(kw.get("exponent", 2.0))
        if p.is_integer():
            fn = lambda x: np.power(x, p)
        else:  # fractional powers: defined on the non-negative branch
            fn = lambda x: np.power(np.maximum(x, 0.0), p)
    else:
        fn = UNIVARIATE_OPS[name]
    return QuantizedTLU(fn=fn, name=name.lower(), n_bits=n_bits)


# -- structural ops ----------------------------------------------------------


@dataclasses.dataclass
class QuantizedReshape(QuantizedOp):
    shape: tuple

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        return np.asarray(x).reshape(self.shape)


@dataclasses.dataclass
class QuantizedTranspose(QuantizedOp):
    perm: tuple

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        return np.transpose(np.asarray(x), self.perm)


@dataclasses.dataclass
class QuantizedSqueeze(QuantizedOp):
    axis: int

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        return np.squeeze(np.asarray(x), axis=self.axis)


@dataclasses.dataclass
class QuantizedUnsqueeze(QuantizedOp):
    axis: int

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        return np.expand_dims(np.asarray(x), axis=self.axis)


@dataclasses.dataclass
class QuantizedExpand(QuantizedOp):
    shape: tuple

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        # ONNX Expand: two-way broadcast (1s in the requested shape keep
        # the data's dimension -- np.broadcast_to alone is one-way)
        x = np.asarray(x)
        return np.broadcast_to(
            x, np.broadcast_shapes(x.shape, tuple(self.shape))
        ).copy()


@dataclasses.dataclass
class QuantizedPad(QuantizedOp):
    pads: tuple  # numpy pad_width format
    value: float = 0.0

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        return np.pad(np.asarray(x), self.pads, constant_values=self.value)


@dataclasses.dataclass
class QuantizedCast(QuantizedOp):
    """ONNX Cast: in the quantized pipeline values stay float-with-int
    semantics; integer casts floor toward zero."""

    to_int: bool = False

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        x = np.asarray(x, np.float64)
        return np.trunc(x) if self.to_int else x


@dataclasses.dataclass
class QuantizedQDQ(QuantizedOp):
    """QuantizeLinear+DequantizeLinear pair on an activation: fake-quant
    with MODEL-provided scale/zero-point. This is the QAT import
    semantics (reference quantization/qat_quantizers.py; brevitas QCDQ
    export): ranges come from training, NOT from calibration data."""

    scale: float = 1.0
    zero_point: float = 0.0
    qmin: int = -128
    qmax: int = 127

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        q = np.clip(
            np.round(np.asarray(x, np.float64) / self.scale)
            + self.zero_point,
            self.qmin, self.qmax,
        )
        return (q - self.zero_point) * self.scale


@dataclasses.dataclass
class QuantizedDequant(QuantizedOp):
    """Standalone DequantizeLinear (integer codes -> float)."""

    scale: float = 1.0
    zero_point: float = 0.0

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        return (np.asarray(x, np.float64) - self.zero_point) * self.scale


@dataclasses.dataclass
class QuantizedMaxPool(QuantizedOp):
    kernel: tuple = (2, 2)
    stride: tuple | None = None

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        kh, kw = self.kernel
        sh, sw = self.stride or self.kernel
        b, c, h, w = x.shape
        oh = (h - kh) // sh + 1
        ow = (w - kw) // sw + 1
        out = np.full((b, c, oh, ow), -np.inf)
        for yy in range(oh):
            for xx in range(ow):
                out[:, :, yy, xx] = x[
                    :, :, yy * sh : yy * sh + kh, xx * sw : xx * sw + kw
                ].max(axis=(2, 3))
        return out


@dataclasses.dataclass
class QuantizedUnfold(QuantizedOp):
    """im2col (reference QuantizedUnfold): (B,C,H,W) -> (B, C*kh*kw, L)."""

    kernel: tuple = (2, 2)
    stride: tuple | None = None

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        kh, kw = self.kernel
        sh, sw = self.stride or self.kernel
        b, c, h, w = x.shape
        oh = (h - kh) // sh + 1
        ow = (w - kw) // sw + 1
        cols = np.zeros((b, c * kh * kw, oh * ow))
        for yy in range(oh):
            for xx in range(ow):
                patch = x[:, :, yy * sh : yy * sh + kh, xx * sw : xx * sw + kw]
                cols[:, :, yy * ow + xx] = patch.reshape(b, -1)
        return cols


# -- multi-input (graph) ops -------------------------------------------------


class GraphOp:
    """Multi-input op for QuantizedGraphModule."""

    n_inputs = 2

    def calibrate(self, *xs):
        return self.forward(*xs, fhe=FheMode.DISABLE)

    def forward(self, *xs, fhe):
        raise NotImplementedError


def _binop(name, fn):
    class _B(GraphOp):
        def forward(self, a, b, fhe=FheMode.DISABLE):
            return fn(np.asarray(a, np.float64), np.asarray(b, np.float64))

    _B.__name__ = f"Quantized{name}"
    return _B


QuantizedAdd = _binop("Add", lambda a, b: a + b)
QuantizedSub = _binop("Sub", lambda a, b: a - b)
QuantizedMul = _binop("Mul", lambda a, b: a * b)
QuantizedDiv = _binop("Div", lambda a, b: a / np.where(b == 0, 1e-12, b))
QuantizedGreater = _binop("Greater", lambda a, b: (a > b).astype(np.float64))
QuantizedGreaterOrEqual = _binop(
    "GreaterOrEqual", lambda a, b: (a >= b).astype(np.float64)
)
QuantizedLess = _binop("Less", lambda a, b: (a < b).astype(np.float64))
QuantizedLessOrEqual = _binop(
    "LessOrEqual", lambda a, b: (a <= b).astype(np.float64)
)
QuantizedEqual = _binop("Equal", lambda a, b: (a == b).astype(np.float64))
QuantizedOr = _binop(
    "Or", lambda a, b: ((a != 0) | (b != 0)).astype(np.float64)
)
QuantizedMin = _binop("Min", np.minimum)
QuantizedMax = _binop("Max", np.maximum)
QuantizedAnd = _binop(
    "And", lambda a, b: ((a != 0) & (b != 0)).astype(np.float64)
)
QuantizedXor = _binop(
    "Xor", lambda a, b: ((a != 0) ^ (b != 0)).astype(np.float64)
)
QuantizedPRelu = _binop("PRelu", lambda a, b: np.where(a > 0, a, b * a))


class QuantizedSum(GraphOp):
    """ONNX Sum: n-ary elementwise add."""

    def __init__(self, n_inputs: int = 2):
        self.n_inputs = n_inputs

    def forward(self, *xs, fhe=FheMode.DISABLE):
        out = np.asarray(xs[0], np.float64)
        for x in xs[1:]:
            out = out + np.asarray(x, np.float64)
        return out


class QuantizedWhere(GraphOp):
    n_inputs = 3

    def forward(self, c, a, b, fhe=FheMode.DISABLE):
        return np.where(np.asarray(c) != 0, a, b)


class QuantizedConcat(GraphOp):
    def __init__(self, axis: int = -1, n_inputs: int = 2):
        self.axis = axis
        self.n_inputs = n_inputs

    def forward(self, *xs, fhe=FheMode.DISABLE):
        return np.concatenate([np.asarray(x) for x in xs], axis=self.axis)


@dataclasses.dataclass
class QuantizedReduceSum(QuantizedOp):
    # int, tuple of ints, or None (= reduce ALL axes, the ONNX
    # missing-axes semantics)
    axis: object = -1
    keepdims: bool = False

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        ax = self.axis
        if isinstance(ax, (list, tuple)):
            ax = tuple(int(a) for a in ax)
        return np.asarray(x, np.float64).sum(
            axis=ax, keepdims=self.keepdims
        )


@dataclasses.dataclass
class QuantizedReduce(QuantizedOp):
    """ReduceMean/Max/Min (reference QuantizedReduce* classes); `axes`
    is a tuple so ONNX axis lists lower directly."""

    kind: str = "mean"  # mean | max | min
    axes: tuple = (-1,)
    keepdims: bool = True

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        x = np.asarray(x, np.float64)
        fn = {"mean": np.mean, "max": np.max, "min": np.min}[self.kind]
        return fn(x, axis=tuple(self.axes), keepdims=self.keepdims)


@dataclasses.dataclass
class QuantizedSoftmax(QuantizedOp):
    """Softmax along `axis`. Under FHE the reference evaluates the exp
    TLU encrypted and normalizes in the clear post-decryption (concrete-ml
    keeps Softmax as the network head); the quantized pipeline computes
    the full stable softmax."""

    axis: int = -1

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        x = np.asarray(x, np.float64)
        z = x - x.max(axis=self.axis, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=self.axis, keepdims=True)


@dataclasses.dataclass
class QuantizedGather(QuantizedOp):
    """Gather with constant indices (the embedding/selection form every
    exported classifier uses; data-dependent indices cannot be evaluated
    under FHE and raise at lowering)."""

    indices: np.ndarray = None
    axis: int = 0

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        return np.take(np.asarray(x), np.asarray(self.indices, np.int64),
                       axis=self.axis)


@dataclasses.dataclass
class QuantizedEmbedding(QuantizedOp):
    """Gather with a CONSTANT table and clear graph-input indices (the
    torch nn.Embedding export form; reference pytest EmbeddingModel)."""

    table: np.ndarray = None
    axis: int = 0

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        # indices may arrive dequantized (e.g. 2.9999): round, not trunc
        idx = np.round(np.asarray(x, np.float64)).astype(np.int64)
        return np.take(np.asarray(self.table), idx, axis=self.axis)


@dataclasses.dataclass
class QuantizedSlice(QuantizedOp):
    """ONNX Slice with constant starts/ends/axes/steps."""

    starts: tuple = ()
    ends: tuple = ()
    axes: tuple | None = None
    steps: tuple | None = None

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        x = np.asarray(x)
        axes = self.axes if self.axes is not None else tuple(
            range(len(self.starts))
        )
        steps = self.steps if self.steps is not None else (1,) * len(axes)
        sl = [slice(None)] * x.ndim
        for st, en, ax, sp in zip(self.starts, self.ends, axes, steps):
            sl[ax] = slice(int(st), None if en >= 2**62 else int(en), int(sp))
        return x[tuple(sl)]


@dataclasses.dataclass
class QuantizedGlobalAveragePool(QuantizedOp):
    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        x = np.asarray(x, np.float64)
        return x.mean(axis=tuple(range(2, x.ndim)), keepdims=True)


@dataclasses.dataclass
class QuantizedResize(QuantizedOp):
    """Nearest-neighbor resize by integer-or-rational scales on the
    spatial dims (the upsampling mode QAT CNNs export)."""

    scales: tuple = (1.0, 1.0)  # spatial (H, W) scales

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        x = np.asarray(x)
        b, c, h, w = x.shape
        sh, sw = self.scales
        oh, ow = int(round(h * sh)), int(round(w * sw))
        yi = np.minimum((np.arange(oh) / sh).astype(np.int64), h - 1)
        xi = np.minimum((np.arange(ow) / sw).astype(np.int64), w - 1)
        return x[:, :, yi][:, :, :, xi]


@dataclasses.dataclass
class QuantizedBatchNormalization(QuantizedOp):
    """Folds to y = a*x + b at calibration (the reference folds BN into
    the preceding linear op; standalone form kept for graph parity)."""

    mean: np.ndarray
    var: np.ndarray
    gamma: np.ndarray
    beta: np.ndarray
    eps: float = 1e-5

    def _affine(self):
        a = self.gamma / np.sqrt(self.var + self.eps)
        return a, self.beta - a * self.mean

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        a, b = self._affine()
        shape = (1, -1) + (1,) * (np.asarray(x).ndim - 2)
        return np.asarray(x) * a.reshape(shape) + b.reshape(shape)


QuantizedMatMul = QuantizedGemm  # reference QuantizedMatMul(QuantizedGemm)


# -- DAG executor ------------------------------------------------------------


@dataclasses.dataclass
class GraphNode:
    op: object
    inputs: tuple  # node ids (or "input" for the graph input)


class QuantizedGraphModule:
    """DAG evaluation (the reference QuantizedModule executes the onnx
    graph the same way: topological node order, values by id).

    nodes: list of GraphNode evaluated in order; node i's result has id
    i; the graph input has id "input"; the LAST node is the output."""

    def __init__(self, nodes: Sequence[GraphNode], n_bits=8):
        from tfhe_tpu_torch.ml.quantization import get_n_bits_dict

        self.nodes = list(nodes)
        self.n_bits_cfg = get_n_bits_dict(n_bits)
        self.n_bits = self.n_bits_cfg["model_inputs"]
        self.input_quantizer: UniformQuantizer | None = None
        # QAT import: model-provided input quantizers (scale/zero-point
        # from training) override calibration fitting -- per input index
        # for multi-input graphs; preset_input_quantizer is the input-0
        # compatibility alias
        self.preset_input_quantizer: UniformQuantizer | None = None
        self.preset_input_quantizers: dict = {}
        self._compiled = False

    @staticmethod
    def _as_inputs(x) -> tuple:
        # TUPLE = multi-input bundle; a plain list is DATA (callers pass
        # nested lists for single-input arrays, which np.asarray coerces)
        return x if isinstance(x, tuple) else (x,)

    def _run(self, x, fhe, calibrate=False):
        xs = self._as_inputs(x)
        vals = {
            ("input" if i == 0 else f"input:{i}"): np.asarray(v, np.float64)
            for i, v in enumerate(xs)
        }
        for i, node in enumerate(self.nodes):
            args = [vals[j] for j in node.inputs]
            if calibrate:
                vals[i] = node.op.calibrate(*args)
            elif isinstance(node.op, (QuantizedOp,)):
                vals[i] = node.op.forward(args[0], fhe)
            else:
                vals[i] = node.op.forward(*args, fhe=fhe)
        return vals[len(self.nodes) - 1]

    def calibrate(self, x_cal):
        xs = tuple(
            np.asarray(v, np.float64) for v in self._as_inputs(x_cal)
        )
        presets = dict(getattr(self, "preset_input_quantizers", None) or {})
        if self.preset_input_quantizer is not None:
            presets.setdefault(0, self.preset_input_quantizer)
        self.input_quantizers = [
            presets[i] if i in presets
            else UniformQuantizer(self.n_bits, is_signed=True).fit(v)
            for i, v in enumerate(xs)
        ]
        self.input_quantizer = self.input_quantizers[0]
        self._run(xs, FheMode.DISABLE, calibrate=True)
        return self

    def compile(self, seed: int = 0, params=None, device=None):
        """FHE keygen for every linear node, on `device` (default
        "cuda"). `params` overrides the GLWE matmul parameter set (tests
        pass TOY_MATMUL to keep keygen cheap; None keeps the production
        default)."""
        for i, node in enumerate(self.nodes):
            if hasattr(node.op, "keygen"):
                if params is not None and getattr(node.op, "_exec", None) is not None:
                    node.op._exec.params = params
                node.op.keygen(seed + i, device)
        self._compiled = True
        return self

    def forward(self, x, fhe=FheMode.DISABLE):
        fhe = FheMode.from_any(fhe)
        if fhe == FheMode.EXECUTE:
            if not self._compiled:
                raise RuntimeError("compile() before fhe='execute'")
        xs = self._as_inputs(x)
        qs = getattr(self, "input_quantizers", None) or [
            self.input_quantizer
        ] * len(xs)
        xs = tuple(
            q.dequant(q.quant(np.asarray(v, np.float64)))
            for q, v in zip(qs, xs)
        )
        return self._run(xs, fhe)

    __call__ = forward
