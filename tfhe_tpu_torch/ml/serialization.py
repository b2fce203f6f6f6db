"""Model serialization: type-tagged JSON dumps/loads for every ML object
(a copy of tfhe_tpu/ml/serialization.py; parameter sets go by name
through tfhe_tpu_torch.params, so the JSON is the JAX package's and a
model dumped by either package loads in the other).

Analog of the reference's serialization package (reference:
ml/concrete-ml/src/concrete/ml/common/serialization/{encoder.py
ConcreteEncoder + dump_name_and_value, decoder.py ConcreteDecoder,
dumpers.py dumps/dump, loaders.py loads/load}): any fitted model,
quantizer, or quantized module round-trips through a JSON string whose
nodes are ``{"type_name": ..., "serialized_value": ...}``. Keys are
NEVER serialized here (same contract as the reference: circuits/keys are
regenerated with .compile() after loading; the deployment triplet in
ml/deploy.py owns key transport).

Classes opt in either by implementing ``dump_dict() -> dict`` and
``load_dict(cls, d)`` and registering via ``@serializable``, or are
handled natively (numpy arrays/scalars, UniformQuantizer, complex
nesting of dict/list/tuple).
"""

from __future__ import annotations

import base64
import json
from typing import Any, IO

import numpy as np

from tfhe_tpu_torch.ml.quantization import QuantizedArray, UniformQuantizer

_TYPE = "type_name"
_VALUE = "serialized_value"

# type_name -> class (for dump_dict/load_dict classes)
SUPPORTED_TYPES: dict[str, type] = {}


def serializable(cls=None, *, name: str | None = None):
    """Class decorator/registrar: opt a dump_dict/load_dict class into
    dumps/loads round-trips under its class name."""

    def reg(c):
        SUPPORTED_TYPES[name or c.__name__] = c
        return c

    return reg(cls) if cls is not None else reg


def _tag(type_name: str, value: Any) -> dict:
    """reference encoder.py:34 dump_name_and_value."""
    return {_TYPE: type_name, _VALUE: value}


def _encode(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, np.ndarray):
        return _tag(
            "numpy_array",
            {
                "dtype": str(obj.dtype),
                "shape": list(obj.shape),
                "data": base64.b64encode(np.ascontiguousarray(obj).tobytes()).decode(),
            },
        )
    if isinstance(obj, np.generic):
        return _tag(
            "numpy_scalar", {"dtype": str(obj.dtype), "value": obj.item()}
        )
    if isinstance(obj, UniformQuantizer):
        return _tag("UniformQuantizer", _encode(obj.to_dict()))
    if isinstance(obj, QuantizedArray):
        return _tag(
            "QuantizedArray",
            {"qvalues": _encode(obj.qvalues), "quantizer": _encode(obj.quantizer)},
        )
    name = getattr(obj, "name", None)
    if isinstance(name, str):
        from tfhe_tpu_torch import params as _tp

        try:
            if _tp.by_name(name) is obj:
                # registered crypto parameter sets serialize by name only
                return _tag("fhe_params", name)
        except (KeyError, ValueError):
            pass
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError("JSON keys must be str")
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return _tag("tuple", [_encode(v) for v in obj])
    if isinstance(obj, list):
        return [_encode(v) for v in obj]
    for tn, cls in SUPPORTED_TYPES.items():
        if type(obj) is cls:
            return _tag(tn, _encode(obj.dump_dict()))
    raise TypeError(
        f"{type(obj).__name__} is not serializable; implement "
        "dump_dict/load_dict and register with @serializable"
    )


def _decode(node: Any) -> Any:
    if isinstance(node, list):
        return [_decode(v) for v in node]
    if not isinstance(node, dict):
        return node
    if set(node) != {_TYPE, _VALUE}:
        return {k: _decode(v) for k, v in node.items()}
    tn, sv = node[_TYPE], node[_VALUE]
    if tn == "numpy_array":
        a = np.frombuffer(
            base64.b64decode(sv["data"]), dtype=np.dtype(sv["dtype"])
        )
        return a.reshape(sv["shape"]).copy()
    if tn == "numpy_scalar":
        return np.dtype(sv["dtype"]).type(sv["value"])
    if tn == "UniformQuantizer":
        return UniformQuantizer.from_dict(_decode(sv))
    if tn == "QuantizedArray":
        return QuantizedArray(
            qvalues=_decode(sv["qvalues"]), quantizer=_decode(sv["quantizer"])
        )
    if tn == "tuple":
        return tuple(_decode(v) for v in sv)
    if tn == "fhe_params":
        from tfhe_tpu_torch import params as _tp

        return _tp.by_name(sv)
    cls = SUPPORTED_TYPES.get(tn)
    if cls is None:
        raise ValueError(f"unknown serialized type: {tn}")
    return cls.load_dict(_decode(sv))


def dumps(obj: Any) -> str:
    """Serialize any supported object to a JSON string
    (reference dumpers.py:9)."""
    return json.dumps(_encode(obj))


def dump(obj: Any, file: IO[str]) -> None:
    """Serialize into an open text file (reference dumpers.py:22)."""
    file.write(dumps(obj))


def loads(content: str | bytes) -> Any:
    """Load any supported object from a JSON string
    (reference loaders.py:9)."""
    if isinstance(content, bytes):
        content = content.decode()
    return _decode(json.loads(content))


def load(file: IO) -> Any:
    """Load from an open file (reference loaders.py:21)."""
    return loads(file.read())
