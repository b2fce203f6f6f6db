"""torch.onnx.export without the `onnx` package: the bridge that makes
ANY torch model (branching, multi-input, functional ops -- not just
Sequential stacks) lowerable through ml/onnx_frontend (a copy of
tfhe_tpu/ml/torch_export.py).

The torchscript exporter serializes the ModelProto itself; it imports
`onnx` only for one post-pass, `_add_onnxscript_fn` (torch
onnx_proto_utils.py:177), which loads the proto to scan for custom
onnx-script functions and -- when there are none, i.e. every standard
model -- returns the bytes untouched. `_OnnxStub` supplies exactly the
surface that scan touches (`load_model_from_string` ->
graph.node[*].domain/.op_type/.attribute[*].g), parsed with the same
wire-format reader as ml/onnx_frontend (reference analog:
concrete-ml requires the real onnx package, torch/compile.py).
"""

from __future__ import annotations

import io
import sys
import types
from typing import Any

from tfhe_tpu_torch.ml.onnx_frontend import _fields


class _StubAttr:
    __slots__ = ("g",)

    def __init__(self, g):
        self.g = g


class _StubNode:
    __slots__ = ("domain", "op_type", "attribute")

    def __init__(self):
        self.domain = ""
        self.op_type = ""
        self.attribute: list[_StubAttr] = []


class _StubGraph:
    __slots__ = ("node",)

    def __init__(self):
        self.node: list[_StubNode] = []


class _StubModel:
    __slots__ = ("graph", "_raw")

    def __init__(self, graph, raw: bytes):
        self.graph = graph
        self._raw = raw

    def SerializeToString(self) -> bytes:  # noqa: N802 (onnx API name)
        return self._raw


def _parse_stub_graph(buf: bytes) -> _StubGraph:
    g = _StubGraph()
    for fno, wt, val in _fields(buf):
        if fno == 1 and wt == 2:  # GraphProto.node
            n = _StubNode()
            for nf, nwt, nval in _fields(val):
                if nf == 4 and nwt == 2:
                    n.op_type = nval.decode()
                elif nf == 7 and nwt == 2:
                    n.domain = nval.decode()
                elif nf == 5 and nwt == 2:  # AttributeProto
                    sub = None
                    for af, awt, aval in _fields(nval):
                        if af == 6 and awt == 2:  # AttributeProto.g
                            sub = _parse_stub_graph(aval)
                    n.attribute.append(_StubAttr(sub))
            g.node.append(n)
    return g


def _load_model_from_string(data: bytes) -> _StubModel:
    graph = _StubGraph()
    for fno, wt, val in _fields(data):
        if fno == 7 and wt == 2:  # ModelProto.graph
            graph = _parse_stub_graph(val)
    return _StubModel(graph, data)


def _install_onnx_stub() -> None:
    if "onnx" in sys.modules:
        return
    import importlib.machinery

    mod = types.ModuleType("onnx")
    mod.load_model_from_string = _load_model_from_string  # type: ignore[attr-defined]
    mod.__tfhe_tpu_stub__ = True  # type: ignore[attr-defined]
    # a real ModuleSpec: importlib.util.find_spec("onnx") raises
    # "onnx.__spec__ is None" otherwise (torch._dynamo.trace_rules walks
    # find_spec over candidate module names at import time)
    mod.__spec__ = importlib.machinery.ModuleSpec("onnx", loader=None)
    sys.modules["onnx"] = mod


def export_onnx_bytes(model, args: Any, **export_kwargs) -> bytes:
    """torch.onnx.export(model, args) -> serialized ModelProto bytes,
    ready for ml/onnx_frontend.compile_onnx_model. Uses the torchscript
    exporter (dynamo=False): its graphs use only standard opset nodes,
    which is what the frontend lowers."""
    import torch

    installed = "onnx" not in sys.modules
    _install_onnx_stub()
    try:
        buf = io.BytesIO()
        export_kwargs.setdefault("dynamo", False)
        torch.onnx.export(model, args, buf, **export_kwargs)
        return buf.getvalue()
    finally:
        # scope the stub to this export: leaving it in sys.modules would
        # shadow a real onnx package for the rest of the process
        if installed and getattr(
            sys.modules.get("onnx"), "__tfhe_tpu_stub__", False
        ):
            del sys.modules["onnx"]


def compile_torch_model_via_onnx(model, x_cal, n_bits: int = 8, seed: int = 0,
                                 keygen: bool = True, params=None, device=None):
    """Full torch -> ONNX -> quantized DAG pipeline (the reference's
    actual compile_torch_model route, torch/compile.py:282: torch models
    are always lowered through ONNX). Complements
    quantized_module.compile_torch_model (direct module traversal) by
    accepting models with branching/functional graphs."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ml.onnx_frontend import compile_onnx_model

    model = model.eval()
    x_cal = np.asarray(x_cal, np.float32)
    ex = torch.tensor(x_cal[:1])
    blob = export_onnx_bytes(model, (ex,))
    return compile_onnx_model(
        blob, x_cal, n_bits=n_bits, seed=seed, keygen=keygen, params=params,
        device=device,
    )
