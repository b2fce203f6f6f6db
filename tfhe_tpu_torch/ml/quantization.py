"""Uniform affine quantization (a copy of tfhe_tpu/ml/quantization.py;
numpy only).

The role of the reference's quantizers (reference:
ml/concrete-ml/src/concrete/ml/quantization/quantizers.py QuantizedArray /
UniformQuantizer: scale/zero-point affine quantization, per-tensor and
per-axis), re-expressed as plain numpy math. The GLWE linear backend
uses dynamic per-channel quantization of activations exactly like the
reference's GLWELinearLayerExecutor (linear_op_glwe_backend.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Default bit-width for the MODEL boundary quantizers when a single int
# is passed for n_bits (reference post_training.py DEFAULT_MODEL_BITS:
# "a compromise between model accuracy and runtime performance in FHE").
DEFAULT_MODEL_BITS = 5

_N_BITS_KEYS = {"model_inputs", "op_weights", "model_outputs", "op_inputs"}


def get_n_bits_dict(n_bits) -> dict:
    """Normalize the n_bits parameter into the four-key dictionary the
    reference uses (post_training.py:127 get_n_bits_dict): an int sets
    op_inputs/op_weights and max(DEFAULT_MODEL_BITS, n) at the model
    boundary; a dict must carry op_inputs + op_weights, the model keys
    default."""
    if isinstance(n_bits, int):
        return {
            "model_inputs": max(DEFAULT_MODEL_BITS, n_bits),
            "op_weights": n_bits,
            "op_inputs": n_bits,
            "model_outputs": max(DEFAULT_MODEL_BITS, n_bits),
        }
    if (
        isinstance(n_bits, dict)
        and set(n_bits) <= _N_BITS_KEYS
        and {"op_weights", "op_inputs"} <= set(n_bits)
    ):
        out = {
            "model_inputs": DEFAULT_MODEL_BITS,
            "model_outputs": max(DEFAULT_MODEL_BITS, n_bits["op_inputs"]),
        }
        out.update(n_bits)
        if out["model_outputs"] < out["op_inputs"]:
            raise ValueError(
                "model_outputs bits must be >= op_inputs bits"
            )
        return out
    raise ValueError(
        "Invalid n_bits: pass an int, or a dict with integer values for "
        "op_weights and op_inputs (mandatory) and model_inputs / "
        f"model_outputs (optional, default {DEFAULT_MODEL_BITS})"
    )


@dataclasses.dataclass
class UniformQuantizer:
    n_bits: int
    is_signed: bool = True
    per_axis: int | None = None  # quantize per this axis (e.g. 0 for rows)

    scale: np.ndarray | None = None
    zero_point: np.ndarray | None = None

    @property
    def qmin(self) -> int:
        return -(2 ** (self.n_bits - 1)) if self.is_signed else 0

    @property
    def qmax(self) -> int:
        return 2 ** (self.n_bits - 1) - 1 if self.is_signed else 2**self.n_bits - 1

    def fit(self, values: np.ndarray) -> "UniformQuantizer":
        v = np.asarray(values, dtype=np.float64)
        if self.per_axis is None:
            vmin, vmax = float(v.min()), float(v.max())
            vmin, vmax = min(vmin, 0.0), max(vmax, 0.0)
            scale = (vmax - vmin) / (self.qmax - self.qmin) or 1.0
            zp = np.round(self.qmin - vmin / scale)
            self.scale = np.float64(scale)
            self.zero_point = np.float64(zp)
        else:
            axes = tuple(i for i in range(v.ndim) if i != self.per_axis)
            vmin = np.minimum(v.min(axis=axes, keepdims=True), 0.0)
            vmax = np.maximum(v.max(axis=axes, keepdims=True), 0.0)
            scale = (vmax - vmin) / (self.qmax - self.qmin)
            scale = np.where(scale == 0.0, 1.0, scale)
            self.scale = scale
            self.zero_point = np.round(self.qmin - vmin / scale)
        return self

    def quant(self, values: np.ndarray) -> np.ndarray:
        q = np.round(np.asarray(values, np.float64) / self.scale + self.zero_point)
        return np.clip(q, self.qmin, self.qmax).astype(np.int64)

    def dequant(self, qvalues: np.ndarray) -> np.ndarray:
        return (np.asarray(qvalues, np.float64) - self.zero_point) * self.scale

    def to_dict(self) -> dict:
        return {
            "n_bits": self.n_bits,
            "is_signed": self.is_signed,
            "per_axis": self.per_axis,
            "scale": np.asarray(self.scale).tolist(),
            "zero_point": np.asarray(self.zero_point).tolist(),
        }

    @staticmethod
    def from_dict(d: dict) -> "UniformQuantizer":
        q = UniformQuantizer(d["n_bits"], d["is_signed"], d["per_axis"])
        q.scale = np.asarray(d["scale"], dtype=np.float64)
        q.zero_point = np.asarray(d["zero_point"], dtype=np.float64)
        return q


@dataclasses.dataclass
class QuantizedArray:
    """values together with their quantizer (QuantizedArray analog)."""

    qvalues: np.ndarray
    quantizer: UniformQuantizer

    @staticmethod
    def quantize(values: np.ndarray, n_bits: int, **kw) -> "QuantizedArray":
        q = UniformQuantizer(n_bits, **kw).fit(values)
        return QuantizedArray(qvalues=q.quant(values), quantizer=q)

    def dequant(self) -> np.ndarray:
        return self.quantizer.dequant(self.qvalues)
