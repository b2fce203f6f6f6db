"""Quantized op graph executor: the FHE inference representation
(counterpart of tfhe_tpu/ml/quantized_module.py; host code over ml/linear).

Analog of the reference's quantized module stack (reference:
ml/concrete-ml/src/concrete/ml/quantization/quantized_module.py
QuantizedModule, quantized_ops.py 54 op classes, post_training.py
calibration): a torch/onnx network is lowered to a sequence of
QuantizedOps over integer tensors; linear ops (Gemm/Conv/MatMul) run on
the encrypted GLWE matmul engine, elementwise nonlinearities become
table lookups (TLUs) applied between linear segments.

Execution modes (ml/common.FheMode, reference common/utils.py:64-104):
  DISABLE  - pure integer pipeline, no crypto (bit-faithful to EXECUTE
             up to ciphertext noise)
  SIMULATE - integer pipeline + analytic noise injection
  EXECUTE  - linear segments encrypted under the GLWE matmul engine;
             TLUs are applied by the CLIENT between segments -- this is
             the HYBRID split (torch/hybrid_model.py), kept because the
             wide-accumulator GLWE matmul admits 8-bit activations.

The FULL-FHE execution path (every TLU a server-side programmable
bootstrap, zero client nonlinearities -- the reference's EXECUTE
semantics) is ml/fhe_pipeline.FheSequential; QAT graphs lower onto it
via ml/qat_fhe.onnx_qat_to_fhe. The trade: fhe_pipeline's accumulators
must fit the msg*carry space (few-bit weights), the hybrid path takes
arbitrary 8-bit layers. Both run the same integer pipeline in DISABLE.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from tfhe_tpu_torch.ml.common import FheMode
from tfhe_tpu_torch.ml.linear import GlweLinearLayerExecutor
from tfhe_tpu_torch.ml.quantization import UniformQuantizer
from tfhe_tpu_torch.ml.serialization import serializable


# -- quantized ops -----------------------------------------------------------


class QuantizedOp:
    """Base: operates on float-dequantized semantics internally; the
    integer view is materialized at linear-op boundaries (the reference's
    'fuse ops into TLUs between linear layers' strategy,
    quantized_module_passes.py)."""

    def calibrate(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def forward(self, x: np.ndarray, fhe: FheMode) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass
@serializable
class QuantizedGemm(QuantizedOp):
    """x @ W + b on the encrypted GLWE matmul engine (reference
    quantized_ops.py QuantizedGemm -> linear_op_glwe_backend)."""

    weights: np.ndarray
    bias: np.ndarray | None
    n_bits: int = 8
    n_bits_w: int | None = None  # weight bits (defaults to n_bits)
    _exec: GlweLinearLayerExecutor | None = None

    def __post_init__(self):
        self._exec = GlweLinearLayerExecutor(
            weights=self.weights,
            bias=self.bias,
            n_bits_in=self.n_bits,
            n_bits_w=self.n_bits_w or self.n_bits,
        )

    def keygen(self, seed: int, device=None):
        self._exec.keygen(seed, device)

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        b = x.shape[:-1]
        out = self._exec.forward(x.reshape(-1, x.shape[-1]), fhe=fhe)
        return out.reshape(*b, -1)

    def dump_dict(self):
        return {"weights": self.weights, "bias": self.bias,
                "n_bits": self.n_bits, "n_bits_w": self.n_bits_w}

    @classmethod
    def load_dict(cls, d):
        return cls(weights=d["weights"], bias=d["bias"], n_bits=d["n_bits"],
                   n_bits_w=d.get("n_bits_w"))


@dataclasses.dataclass
@serializable
class QuantizedConv(QuantizedOp):
    """2-D convolution lowered to im2col + Gemm: the matmul-native form (the
    reference lowers Conv to the same integer matmul semantics,
    quantized_ops.py QuantizedConv)."""

    weights: np.ndarray  # (O, I, kh, kw)
    bias: np.ndarray | None
    stride: tuple = (1, 1)
    padding: tuple = (0, 0)
    n_bits: int = 8
    n_bits_w: int | None = None  # weight bits (defaults to n_bits)
    _exec: GlweLinearLayerExecutor | None = None

    def __post_init__(self):
        o, i, kh, kw = self.weights.shape
        wmat = self.weights.reshape(o, i * kh * kw).T  # (I*kh*kw, O)
        self._exec = GlweLinearLayerExecutor(
            weights=wmat,
            bias=self.bias,
            n_bits_in=self.n_bits,
            n_bits_w=self.n_bits_w or self.n_bits,
        )

    def keygen(self, seed: int, device=None):
        self._exec.keygen(seed, device)

    def _im2col(self, x):
        b, c, h, w = x.shape
        _, _, kh, kw = self.weights.shape
        sh, sw = self.stride
        ph, pw = self.padding
        xp = np.pad(x, ((0, 0), (0, 0), (ph, ph), (pw, pw)))
        oh = (h + 2 * ph - kh) // sh + 1
        ow = (w + 2 * pw - kw) // sw + 1
        cols = np.empty((b, oh * ow, c * kh * kw), dtype=x.dtype)
        idx = 0
        for yy in range(oh):
            for xx in range(ow):
                patch = xp[:, :, yy * sh : yy * sh + kh, xx * sw : xx * sw + kw]
                cols[:, idx, :] = patch.reshape(b, -1)
                idx += 1
        return cols, oh, ow

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        b = x.shape[0]
        cols, oh, ow = self._im2col(np.asarray(x, np.float64))
        out = self._exec.forward(cols.reshape(b * oh * ow, -1), fhe=fhe)
        o = out.shape[-1]
        return out.reshape(b, oh, ow, o).transpose(0, 3, 1, 2)

    def dump_dict(self):
        return {"weights": self.weights, "bias": self.bias,
                "stride": self.stride, "padding": self.padding,
                "n_bits": self.n_bits, "n_bits_w": self.n_bits_w}

    @classmethod
    def load_dict(cls, d):
        return cls(weights=d["weights"], bias=d["bias"],
                   stride=tuple(d["stride"]), padding=tuple(d["padding"]),
                   n_bits=d["n_bits"], n_bits_w=d.get("n_bits_w"))


@dataclasses.dataclass
@serializable
class QuantizedTLU(QuantizedOp):
    """Elementwise nonlinearity as an n_bits-wide table lookup (the
    reference fuses all elementwise ops between linear layers into one
    TLU; quantized_module_passes.py).

    `p_error` models the PBS failure probability in SIMULATE mode: each
    table input is bumped +-1 level with that probability (the blind
    rotation's mod-switch rounding landing one box off -- the failure
    mode p_error parameterizes). ml/p_error_search.py sweeps it."""

    fn: Callable[[np.ndarray], np.ndarray]
    name: str = "tlu"
    n_bits: int = 8
    p_error: float = 0.0
    _q: UniformQuantizer | None = None

    def calibrate(self, x):
        self._q = UniformQuantizer(self.n_bits, is_signed=True).fit(x)
        return self.fn(x)

    def forward(self, x, fhe):
        if self._q is None or fhe == FheMode.DISABLE:
            return self.fn(x)
        # quantize -> table -> dequantize: exactly what the PBS evaluates
        xq = self._q.quant(x)
        if fhe == FheMode.SIMULATE and self.p_error > 0.0:
            rs = np.random.RandomState(
                int(self.p_error * 2**30) ^ xq.size
            )
            flip = rs.random(xq.shape) < self.p_error
            delta = np.where(rs.random(xq.shape) < 0.5, -1, 1)
            xq = np.clip(
                xq + flip * delta, self._q.qmin, self._q.qmax
            ).astype(np.int64)
        levels = np.arange(self._q.qmin, self._q.qmax + 1)
        table = self.fn(self._q.dequant(levels))
        return table[(xq - self._q.qmin).astype(np.int64)]

    def dump_dict(self):
        d = {"name": self.name, "n_bits": self.n_bits,
             "p_error": self.p_error, "q": self._q}
        if self.name not in _TORCH_TLUS:
            # anonymous callable: serialize the BAKED table over the
            # calibrated levels (exactly what the PBS would evaluate);
            # requires calibration first
            if self._q is None:
                raise RuntimeError(
                    f"TLU {self.name!r} is not a registry function; calibrate "
                    "before dumping so the table can be baked")
            levels = np.arange(self._q.qmin, self._q.qmax + 1)
            d["baked_inputs"] = self._q.dequant(levels)
            d["baked_table"] = np.asarray(self.fn(d["baked_inputs"]), np.float64)
        return d

    @classmethod
    def load_dict(cls, d):
        if d["name"] in _TORCH_TLUS:
            fn = _TORCH_TLUS[d["name"]]
        else:
            xs = d["baked_inputs"]
            ys = d["baked_table"]

            def fn(v, xs=xs, ys=ys):
                # nearest-level lookup: exact on the quantized grid
                idx = np.clip(np.searchsorted(xs, v), 0, len(xs) - 1)
                lo = np.clip(idx - 1, 0, len(xs) - 1)
                use_lo = np.abs(v - xs[lo]) <= np.abs(xs[idx] - v)
                return ys[np.where(use_lo, lo, idx)]

        op = cls(fn=fn, name=d["name"], n_bits=d["n_bits"], p_error=d["p_error"])
        op._q = d["q"]
        return op


@dataclasses.dataclass
@serializable
class QuantizedAvgPool(QuantizedOp):
    kernel: tuple = (2, 2)
    stride: tuple | None = None

    def dump_dict(self):
        return {"kernel": self.kernel, "stride": self.stride}

    @classmethod
    def load_dict(cls, d):
        s = d["stride"]
        return cls(kernel=tuple(d["kernel"]),
                   stride=None if s is None else tuple(s))

    def calibrate(self, x):
        return self.forward(x, FheMode.DISABLE)

    def forward(self, x, fhe):
        kh, kw = self.kernel
        sh, sw = self.stride or self.kernel
        b, c, h, w = x.shape
        oh = (h - kh) // sh + 1
        ow = (w - kw) // sw + 1
        out = np.zeros((b, c, oh, ow), dtype=np.float64)
        for yy in range(oh):
            for xx in range(ow):
                out[:, :, yy, xx] = x[
                    :, :, yy * sh : yy * sh + kh, xx * sw : xx * sw + kw
                ].mean(axis=(2, 3))
        return out


@dataclasses.dataclass
@serializable
class QuantizedFlatten(QuantizedOp):
    def dump_dict(self):
        return {}

    @classmethod
    def load_dict(cls, d):
        return cls()

    def calibrate(self, x):
        return x.reshape(x.shape[0], -1)

    def forward(self, x, fhe):
        return x.reshape(x.shape[0], -1)


# -- module ------------------------------------------------------------------


@serializable
class QuantizedModule:
    """Ordered quantized op pipeline with input/output quantizers
    (reference quantized_module.py QuantizedModule: quantize_input :
    forward : dequantize_output)."""

    def __init__(self, ops: Sequence[QuantizedOp], n_bits=8):
        from tfhe_tpu_torch.ml.quantization import get_n_bits_dict

        self.ops = list(ops)
        self.n_bits_cfg = get_n_bits_dict(n_bits)
        self.n_bits = self.n_bits_cfg["op_inputs"]
        self.input_quantizer: UniformQuantizer | None = None
        self._compiled = False

    def calibrate(self, x_cal: np.ndarray):
        x = np.asarray(x_cal, np.float64)
        self.input_quantizer = UniformQuantizer(
            self.n_bits_cfg["model_inputs"], is_signed=True
        ).fit(x)
        for op in self.ops:
            x = op.calibrate(x)
        return self

    def compile(self, seed: int = 0, device=None):
        """Generate FHE keys for every encrypted linear op (the
        reference's circuit-compile step), on `device` (default "cuda")."""
        for i, op in enumerate(self.ops):
            if hasattr(op, "keygen"):
                op.keygen(seed + i, device)
        self._compiled = True
        return self

    def quantize_input(self, x):
        return self.input_quantizer.quant(np.asarray(x, np.float64))

    def dequantize_input(self, xq):
        return self.input_quantizer.dequant(xq)

    def forward(self, x, fhe: FheMode | str = FheMode.DISABLE) -> np.ndarray:
        fhe = FheMode.from_any(fhe)
        if fhe == FheMode.EXECUTE:
            if not self._compiled:
                raise RuntimeError("compile() before fhe='execute'")
        # input quantization round-trip: the deployed pipeline only ever
        # sees quantized inputs
        x = self.dequantize_input(self.quantize_input(x))
        for op in self.ops:
            x = op.forward(np.asarray(x, np.float64), fhe)
        return x

    __call__ = forward

    def dump_dict(self):
        # the full four-key config: dumping only op_inputs would make a
        # re-calibrate after load fit the wrong model_inputs width
        return {"ops": list(self.ops), "n_bits": dict(self.n_bits_cfg),
                "input_quantizer": self.input_quantizer}

    @classmethod
    def load_dict(cls, d):
        qm = cls(d["ops"], n_bits=d["n_bits"])
        qm.input_quantizer = d["input_quantizer"]
        return qm

    def dumps(self) -> str:
        from tfhe_tpu_torch.ml import serialization

        return serialization.dumps(self)


# -- torch frontend ------------------------------------------------------------


_TORCH_TLUS = {
    "ReLU": lambda x: np.maximum(x, 0.0),
    "ReLU6": lambda x: np.clip(x, 0.0, 6.0),
    "Sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "Tanh": np.tanh,
    "GELU": lambda x: 0.5 * x * (1.0 + np.tanh(0.7978845608 * (x + 0.044715 * x**3))),
    "SiLU": lambda x: x / (1.0 + np.exp(-x)),
    "ELU": lambda x: np.where(x > 0, x, np.exp(np.minimum(x, 0.0)) - 1.0),
    "Softplus": lambda x: np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0.0),
    "Hardtanh": lambda x: np.clip(x, -1.0, 1.0),
    "LeakyReLU": lambda x: np.where(x > 0, x, 0.01 * x),
}


def _lower_torch_module(module, n_bits) -> list:
    """Flatten a torch module into QuantizedOps (reference
    torch/compile.py builds the same op sequence via ONNX export; torch
    module traversal avoids the onnx dependency, which is not vendored).
    n_bits: int or the reference's four-key dict (op_inputs/op_weights
    drive the per-layer quantizers)."""
    import torch.nn as nn

    from tfhe_tpu_torch.ml.quantization import get_n_bits_dict

    nb = get_n_bits_dict(n_bits)
    n_bits, n_bits_w = nb["op_inputs"], nb["op_weights"]

    ops: list[QuantizedOp] = []

    def visit(m):
        cls = type(m).__name__
        if isinstance(m, nn.Sequential):
            for ch in m:
                visit(ch)
        elif isinstance(m, nn.Linear):
            w = m.weight.detach().cpu().numpy().T  # (in, out)
            b = m.bias.detach().cpu().numpy() if m.bias is not None else None
            ops.append(QuantizedGemm(weights=w, bias=b, n_bits=n_bits,
                                     n_bits_w=n_bits_w))
        elif isinstance(m, nn.Conv2d):
            if m.groups != 1:
                raise NotImplementedError("grouped conv not supported")
            ops.append(
                QuantizedConv(
                    weights=m.weight.detach().cpu().numpy(),
                    bias=m.bias.detach().cpu().numpy() if m.bias is not None else None,
                    stride=tuple(m.stride),
                    padding=tuple(m.padding),
                    n_bits=n_bits,
                    n_bits_w=n_bits_w,
                )
            )
        elif isinstance(m, nn.AvgPool2d):
            k = (m.kernel_size,) * 2 if isinstance(m.kernel_size, int) else tuple(m.kernel_size)
            s = None if m.stride is None else ((m.stride,) * 2 if isinstance(m.stride, int) else tuple(m.stride))
            ops.append(QuantizedAvgPool(kernel=k, stride=s))
        elif isinstance(m, nn.Flatten):
            ops.append(QuantizedFlatten())
        elif cls in _TORCH_TLUS:
            ops.append(QuantizedTLU(fn=_TORCH_TLUS[cls], name=cls, n_bits=n_bits))
        elif isinstance(m, (nn.Dropout, nn.Identity)):
            pass  # inference no-ops
        else:
            children = list(m.children())
            if not children:
                raise NotImplementedError(f"unsupported torch layer: {cls}")
            for ch in children:
                visit(ch)

    visit(module)
    return ops


def compile_torch_model(
    model,
    torch_inputset,
    n_bits: int = 8,
    rounding_threshold_bits=None,
    **_ignored,
) -> QuantizedModule:
    """Post-training-quantize a torch model for FHE inference (reference:
    ml/concrete-ml/src/concrete/ml/torch/compile.py:282
    compile_torch_model). Returns a calibrated QuantizedModule; call
    .compile() to generate keys, then .forward(x, fhe='execute')."""
    import torch

    model = model.eval()
    if isinstance(torch_inputset, torch.Tensor):
        cal = torch_inputset.detach().cpu().numpy()
    else:
        cal = np.asarray(torch_inputset, np.float64)
    ops = _lower_torch_module(model, n_bits)
    qm = QuantizedModule(ops, n_bits=n_bits)
    qm.calibrate(cal.astype(np.float64))
    return qm


def compile_onnx_model(onnx_model, inputset, n_bits: int = 8, **kw):
    """Reference torch/compile.py:369: delegate to the from-scratch ONNX
    frontend (wire-format parser, no onnx package needed). `onnx_model`
    is a path or serialized ModelProto bytes."""
    from tfhe_tpu_torch.ml.onnx_frontend import compile_onnx_model as _compile

    return _compile(onnx_model, inputset, n_bits=n_bits, **kw)


def compile_brevitas_qat_model(model, inputset, n_bits: int = 8, **kw):
    """Reference torch/compile.py:452 (QAT import). brevitas itself is
    not vendored in this image; its interchange format is -- brevitas
    models export to ONNX QCDQ (QuantizeLinear/DequantizeLinear carrying
    the trained scales), which ml/onnx_frontend.compile_qat_onnx_model
    imports with model-provided quantizers. Pass the exported bytes or
    path; a live brevitas nn.Module raises with that guidance."""
    if isinstance(model, (str, bytes)):
        from tfhe_tpu_torch.ml.onnx_frontend import compile_qat_onnx_model

        return compile_qat_onnx_model(model, inputset, n_bits=n_bits, **kw)
    raise NotImplementedError(
        "brevitas is not available in this build; export the QAT model "
        "to ONNX QCDQ (brevitas export_onnx_qcdq) and pass the bytes/path"
    )
