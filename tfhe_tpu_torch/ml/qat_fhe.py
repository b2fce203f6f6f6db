"""QAT graph -> full-FHE pipeline: zero client-side nonlinearities
(counterpart of tfhe_tpu/ml/qat_fhe.py; host lowering onto
ml/fhe_pipeline, whose keys go on `device`, default "cuda").

Bridges the two halves of the ML stack: `onnx_frontend`'s QCDQ (QAT)
import and `fhe_pipeline`'s encrypted executor. A brevitas-style QAT
export carries every quantizer (scale s, zero-point zp) as
QuantizeLinear/DequantizeLinear initializers; this module walks the
UN-folded graph and emits an FheSequential where

  * every Conv/Gemm becomes an EXACT integer LWE linear layer: the
    weight's trained grid w_int = round(w / s_w) (recovered from its
    Q/DQ pair), bias folded to b_int = round(b / (s_in * s_w)) minus the
    input zero-point correction zp_in * sum_k w_int[o, k];
  * every activation boundary (nonlinearity + next QuantizeLinear)
    becomes ONE programmable-bootstrap TLU evaluating
        q_out = clip(round(f(acc * s_in * s_w) / s_out) + zp_out)
    -- requantization rides the same PBS as the nonlinearity, exactly
    the reference's fuse-into-TLU strategy
    (quantized_module_passes.py), but server-side under FHE.

The client encrypts the INPUT CODES once and decrypts OUTPUT CODES
once; all scales live in the tables. Reference:
torch/compile.py:452 compile_brevitas_qat_model + the EXECUTE mode of
quantization/quantized_module.py.

Accumulator discipline: FheSequential.compile() walks the integer
ranges and fails closed (AccumulatorOverflow) when a layer exceeds the
msg*carry plaintext space -- the same constraint concrete-ml's bit-width
checker enforces (post_training.py).
"""

from __future__ import annotations

import numpy as np

from tfhe_tpu_torch.ml.fhe_pipeline import (
    FheConv2d,
    FheLinear,
    FheSequential,
    FheTlu,
)
from tfhe_tpu_torch.ml.onnx_frontend import OnnxGraph, parse_model, _qdq_bounds
from tfhe_tpu_torch.params import ShortintParams

_ACTS = {
    "Relu": lambda v: np.maximum(v, 0.0),
    "Identity": lambda v: v,
}


def _scale_zp(g: OnnxGraph, node) -> tuple[float, float, int, int]:
    s = float(np.asarray(g.initializers[node.inputs[1]].data).ravel()[0])
    zp_t = (
        np.asarray(g.initializers[node.inputs[2]].data)
        if len(node.inputs) > 2 and node.inputs[2] in g.initializers
        else np.zeros((), np.int8)
    )
    qmin, qmax = _qdq_bounds(zp_t)
    return s, float(np.asarray(zp_t, np.float64).ravel()[0]), qmin, qmax


def _weight_grid(g: OnnxGraph, name: str, producers: dict):
    """Trace a Conv/Gemm weight input back through its DQ(Q(w)) pair and
    return (w_int, s_w). A bare float initializer has no trained grid
    and is rejected (not a QAT export)."""
    if name in g.initializers:
        raise ValueError(
            f"weight '{name}' is a raw float initializer -- QAT exports "
            "route weights through QuantizeLinear/DequantizeLinear"
        )
    node = producers[name]
    if node.op_type != "DequantizeLinear":
        raise ValueError(f"weight '{name}' comes from {node.op_type}, not DequantizeLinear")
    s, zp, _, _ = _scale_zp(g, node)
    src = node.inputs[0]
    if src in g.initializers:  # DQ over stored integer codes
        w_q = np.asarray(g.initializers[src].data, np.float64)
    else:
        qn = producers[src]
        if qn.op_type != "QuantizeLinear":
            raise ValueError(f"weight '{name}' is dequantized from {qn.op_type}, not QuantizeLinear")
        w_f = np.asarray(g.initializers[qn.inputs[0]].data, np.float64)
        sq, zq, qmin, qmax = _scale_zp(g, qn)
        w_q = np.clip(np.round(w_f / sq) + zq, qmin, qmax)
    return (w_q - zp).astype(np.int64), s


def onnx_qat_to_fhe(
    model,
    params: ShortintParams,
    in_hw: tuple | None = None,
    seed: int = 0,
    device=None,
) -> tuple[FheSequential, dict]:
    """QCDQ ONNX bytes/path -> (FheSequential with keys on `device`,
    default "cuda"; io spec).

    Supported chain: [Q/DQ input] -> (Conv|Gemm|MatMul) -> [Relu] ->
    Q/DQ -> ... -> output (Flatten/Reshape/Identity are free). The io
    spec holds the input/output quantizers so callers move between
    float and code domains:
      quantize_input(x)  = clip(round(x/s_in)+zp_in) - qmin_in  (>= 0)
      dequantize_output(q) = (q - zp_out) * s_out
    """
    data = open(model, "rb").read() if isinstance(model, str) else model
    g = parse_model(data)
    producers = {o: n for n in g.nodes for o in n.outputs}

    # input quantizer: the Q node fed by the graph input
    s_cur = zp_cur = None
    qmin_in = 0
    layers: list = []
    pending_act = "Identity"
    pending_linear = None  # (w_int (O,K), s_w, b_f, kind, conv_meta)
    hw = in_hw

    def close_segment(s_out, zp_out, qmax_out):
        """Emit the pending linear + the TLU that applies the activation
        and requantizes onto the next grid."""
        nonlocal pending_linear, pending_act, s_cur, zp_cur, hw
        if pending_linear is None:
            raise ValueError("Q/DQ boundary without a linear")
        w_int, s_w, b_f, kind, meta = pending_linear
        s_in, zp_in = s_cur, zp_cur
        # fold input zero-point + float bias into the integer bias
        row_sum = w_int.sum(axis=1)
        b_int = -np.asarray(zp_in * row_sum, np.float64)
        if b_f is not None:
            b_int = b_int + np.round(np.asarray(b_f, np.float64) / (s_in * s_w))
        b_int = b_int.astype(np.int64)
        if kind == "conv":
            cout, cin, kh, kw = meta
            if hw is None:
                raise ValueError("pass in_hw for Conv networks")
            layers.append(
                FheConv2d(
                    w_int.reshape(cout, cin, kh, kw), in_hw=hw, b_int=b_int
                )
            )
            hw = layers[-1].out_hw
        else:
            layers.append(FheLinear(w_int.T, b_int=b_int))
        f = _ACTS[pending_act]
        space = params.message_modulus * params.carry_modulus
        hi_code = min(int(qmax_out - zp_out), space - 1)
        ssw = s_in * s_w

        def table(acc, _f=f, _ssw=ssw, _so=s_out, _zp=zp_out, _hi=hi_code):
            return int(
                np.clip(np.round(_f(acc * _ssw) / _so) + _zp, 0, _hi)
            )

        layers.append(FheTlu(table))
        pending_linear, pending_act = None, "Identity"
        s_cur, zp_cur = s_out, zp_out

    for node in g.nodes:
        t = node.op_type
        if t == "QuantizeLinear":
            src = node.inputs[0]
            s, zp, qmin, qmax = _scale_zp(g, node)
            if src in g.inputs:  # the input quantizer
                s_cur, zp_cur, qmin_in = s, zp, qmin
                # encrypt codes shifted to >= 0: zp absorbed via qmin shift
                zp_cur = zp - qmin
            elif src in g.initializers:
                continue  # weight Q: handled by _weight_grid
            else:
                close_segment(s, zp, qmax)
        elif t == "DequantizeLinear":
            continue  # identity half of every Q/DQ pair
        elif t in ("Conv", "Gemm", "MatMul"):
            if pending_linear is not None:
                raise ValueError("two linears without a Q/DQ")
            w_int, s_w = _weight_grid(g, node.inputs[1], producers)
            b_f = None
            if len(node.inputs) > 2 and node.inputs[2] in g.initializers:
                b_f = g.initializers[node.inputs[2]].data
            if t == "Conv":
                meta = w_int.shape
                pending_linear = (
                    w_int.reshape(w_int.shape[0], -1), s_w, b_f, "conv", meta
                )
            else:
                if t == "Gemm" and node.attrs.get("transB", 0):
                    w_int = w_int  # (O, C) already row-major
                else:
                    w_int = w_int.T  # MatMul stores (C, O)
                pending_linear = (w_int, s_w, b_f, "gemm", None)
        elif t in _ACTS:
            pending_act = t
        elif t in ("Flatten", "Reshape", "Identity", "Cast"):
            continue  # channel-major flat layout is preserved
        else:
            raise NotImplementedError(
                f"op {t} has no full-FHE lowering (supported: Conv, Gemm, "
                "MatMul, Relu, Flatten, Reshape + Q/DQ boundaries)"
            )

    if pending_linear is not None:
        raise ValueError(
            "graph ends on an open linear segment: QAT exports close "
            "every segment with a QuantizeLinear"
        )

    space = params.message_modulus * params.carry_modulus
    net = FheSequential(layers, params, seed=seed, device=device)
    io = {"qmin_in": qmin_in, "space": space}
    return net, io


def run_qat_fhe(model, params: ShortintParams, x: np.ndarray,
                in_hw: tuple | None = None, seed: int = 0, device=None):
    """Convenience end-to-end: build, compile, encrypt codes, run under
    FHE, return (decrypted codes, clear-pipeline codes) for callers to
    pin against the float model."""
    data = open(model, "rb").read() if isinstance(model, str) else model
    g = parse_model(data)
    first_q = next(n for n in g.nodes if n.op_type == "QuantizeLinear"
                   and n.inputs[0] in g.inputs)
    s_in, zp_in, qmin_in, qmax_in = _scale_zp(g, first_q)

    net, io = onnx_qat_to_fhe(data, params, in_hw=in_hw, seed=seed, device=device)
    codes = np.clip(
        np.round(np.asarray(x, np.float64) / s_in) + zp_in, qmin_in, qmax_in
    ).astype(np.int64) - qmin_in  # shift to >= 0 for the LWE domain
    codes = codes.reshape(codes.shape[0], -1)  # (batch, Cin*H*W) layout
    net.compile(input_hi=int(codes.max()))
    got = net.decrypt(net.run(net.encrypt(codes)))
    want = net.clear_forward(codes)
    return got, want
