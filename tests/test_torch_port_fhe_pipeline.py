"""The full-FHE pipeline (ml/fhe_pipeline, ml/qat_fhe) of tfhe_tpu_torch
against the JAX package, on the CPU.

One JAX keygen at TOY_SHORTINT for the file, carried across; both
packages' FheSequential constructors are handed those keys (their keygen
patched), and the ciphertexts the JAX package encrypts are carried too:
* FheLinear and FheConv2d, with and without bias, over one and two
  leading batch dims: output ciphertexts bit-exact;
* FheSequential with two TLU layers (signed accumulators, so the offset
  path runs): the LUTs and run() bit-exact, decrypt equal to
  clear_forward; AccumulatorOverflow at the same layer with the same text;
* onnx_qat_to_fhe on the QCDQ CNN of tests/test_qat_fhe.py: the same
  layers (weights, gather maps, biases, offsets, LUTs); run_qat_fhe gives
  the same codes;
* a TLU layer is one batched PBS: one apply_lut a layer, and at a level-1
  k=1 key one fused rotation over all B*O ciphertexts;
* the limb product's operand guard (int8 on CUDA, int32 sums).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tfhe_tpu import params as jp
from tfhe_tpu.ml import fhe_pipeline as jfp
from tfhe_tpu.ml import qat_fhe as jqat
from tfhe_tpu.models import shortint as jsi
from tfhe_tpu_torch import _u64, convert
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch.core import bootstrap as tbt
from tfhe_tpu_torch.core.lwe import check_limb_lhs
from tfhe_tpu_torch.ml import fhe_pipeline as tfp
from tfhe_tpu_torch.ml import qat_fhe as tqat
from tests.test_qat_fhe import _qat_cnn


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes side by side; the port's many
    small tensor ops run fastest, and slow the other processes least, on
    one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def keys():
    """JAX TOY_SHORTINT keys (seed 5) and the port's copy."""
    jck, jsk = jsi.keygen(jp.TOY_SHORTINT, seed=5)
    return (jck, jsk), convert.keys_from_reference(jck, jsk, device="cpu")


@pytest.fixture
def carried(keys, monkeypatch):
    """Both packages' FheSequential get the fixture's keys."""
    (jck, jsk), (tck, tsk) = keys
    monkeypatch.setattr(jfp.si, "keygen", lambda params, seed=0: (jck, jsk))
    monkeypatch.setattr(tfp.si, "keygen", lambda params, seed=0, device=None: (tck, tsk))


def _pair(make_layers):
    """The same network in both packages on the carried keys."""
    return (jfp.FheSequential(make_layers(jfp), jp.TOY_SHORTINT),
            tfp.FheSequential(make_layers(tfp), tp.TOY_SHORTINT, device="cpu"))


def _carry_ct(jx):
    """A JAX FheTensor's ciphertexts as the port's."""
    return tfp.FheTensor(ct=convert.u64_tensor(np.asarray(jx.ct)), params=tp.TOY_SHORTINT, degree=jx.degree)


def _same_bits(port_ct, jax_ct):
    np.testing.assert_array_equal(_u64.u64_to_numpy(port_ct), np.asarray(jax_ct))


def relu_q(v: int) -> int:
    return max(0, min(int(v), 3))


rng = np.random.default_rng(23)
W_SIGNED = rng.integers(-1, 2, size=(3, 4))


@pytest.mark.parametrize(
    "w,b,x_shape",
    [
        (W_SIGNED, None, (4, 3)),
        (W_SIGNED, np.array([1, -2, 0, 3]), (4, 3)),
        (np.array([[2], [3], [1]]), np.array([-1]), (2, 3, 3)),
    ],
    ids=["signed", "bias", "batch_dims"],
)
def test_fhe_linear_matches_reference(carried, w, b, x_shape):
    jnet, _ = _pair(lambda m: [m.FheLinear(w, b_int=b), m.FheTlu(relu_q)])
    x = np.random.default_rng(1).integers(0, 4, size=x_shape)
    jx = jnet.encrypt(x)
    got = tfp.FheLinear(w, b_int=b).forward(_carry_ct(jx))
    _same_bits(got, jfp.FheLinear(w, b_int=b).forward(jx))


@pytest.mark.parametrize(
    "w_shape,in_hw,stride,bias",
    [((2, 1, 2, 2), (3, 3), 1, None), ((2, 2, 2, 2), (4, 4), 2, np.array([2, -1]))],
    ids=["stride1", "stride2_bias"],
)
def test_fhe_conv2d_matches_reference(carried, w_shape, in_hw, stride, bias):
    w = np.random.default_rng(2).integers(-1, 2, size=w_shape)
    cin = w_shape[1]
    jnet, _ = _pair(lambda m: [m.FheLinear(np.eye(cin * in_hw[0] * in_hw[1], dtype=np.int64)), m.FheTlu(relu_q)])
    x = np.random.default_rng(3).integers(0, 2, size=(2, cin * in_hw[0] * in_hw[1]))
    jx = jnet.encrypt(x)
    jconv = jfp.FheConv2d(w, in_hw=in_hw, b_int=bias, stride=stride)
    tconv = tfp.FheConv2d(w, in_hw=in_hw, b_int=bias, stride=stride)
    np.testing.assert_array_equal(tconv.idx, jconv.idx)
    assert tconv.out_hw == jconv.out_hw
    _same_bits(tconv.forward(_carry_ct(jx)), jconv.forward(jx))
    np.testing.assert_array_equal(tconv.clear_apply(x), jconv.clear_apply(x))


def test_conv2d_as_linear_matches_reference():
    w = np.random.default_rng(4).integers(-1, 2, size=(3, 2, 3, 3))
    np.testing.assert_array_equal(tfp.conv2d_as_linear(w, (5, 4), 1).w, jfp.conv2d_as_linear(w, (5, 4), 1).w)
    np.testing.assert_array_equal(tfp.conv2d_as_linear(w, (6, 6), 2).w, jfp.conv2d_as_linear(w, (6, 6), 2).w)


# The networks' TLU layers all bootstrap (2, 8) and then (2, 2) values, so
# the JAX package compiles each PBS shape once for the file.
def _mlp(m):
    w1 = np.array([[1, -1, 1, 0, 1, 0, -1, 1], [1, 1, -1, 1, 0, -1, 0, 1]])
    w2 = np.zeros((8, 2), dtype=np.int64)
    w2[0, 0], w2[3, 0], w2[1, 1], w2[6, 1] = 1, -1, 1, 1
    b1 = np.array([0, -1, 1, 0, 0, 1, 2, -2])
    return [m.FheLinear(w1, b_int=b1), m.FheTlu(relu_q), m.FheLinear(w2), m.FheTlu(lambda v: abs(v) % 4)]


def _cnn(m):
    w = np.random.default_rng(3).integers(-1, 2, size=(2, 1, 3, 3))
    head = np.zeros((8, 2), dtype=np.int64)  # two taps a class keep the accumulator in range
    head[0, 0], head[5, 0], head[2, 1], head[7, 1] = 1, -1, 1, 1
    return [m.FheConv2d(w, in_hw=(4, 4)), m.FheTlu(relu_q), m.FheLinear(head), m.FheTlu(lambda v: max(-8, min(7, v)) + 8)]


@pytest.mark.parametrize("make,x_hi,x_shape", [(_mlp, 3, (2, 2)), (_cnn, 1, (2, 16))], ids=["mlp", "cnn"])
def test_sequential_run_bit_exact(carried, make, x_hi, x_shape):
    jnet, tnet = _pair(make)
    jnet.compile(input_hi=x_hi)
    tnet.compile(input_hi=x_hi)
    assert tnet.output_range == jnet.output_range
    assert [l.offset for l in tnet.layers if isinstance(l, tfp.FheTlu)] == \
        [l.offset for l in jnet.layers if isinstance(l, jfp.FheTlu)]
    assert any(l.offset for l in tnet.layers if isinstance(l, tfp.FheTlu))  # the offset path runs
    for tl, jl in zip(tnet._luts, jnet._luts):
        _same_bits(tl, jl)
    x = np.random.default_rng(5).integers(0, x_hi + 1, size=x_shape)
    jx = jnet.encrypt(x)
    jy = jnet.run(jx)
    ty = tnet.run(_carry_ct(jx))
    _same_bits(ty.ct, jy.ct)
    got = tnet.decrypt(ty)
    np.testing.assert_array_equal(got, jnet.decrypt(jy))
    np.testing.assert_array_equal(got, tnet.clear_forward(x))
    np.testing.assert_array_equal(tnet.clear_forward(x), jnet.clear_forward(x))


def test_accumulator_overflow_at_the_same_layer(carried):
    def make(m):
        return [m.FheLinear(np.array([[1], [1]])), m.FheTlu(relu_q), m.FheLinear(np.full((1, 1), 6))]

    jnet, tnet = _pair(make)
    with pytest.raises(jfp.AccumulatorOverflow) as jerr:
        jnet.compile(input_hi=3)
    with pytest.raises(tfp.AccumulatorOverflow) as terr:
        tnet.compile(input_hi=3)
    assert str(terr.value) == str(jerr.value) and str(terr.value).startswith("layer 2:")


def _qat_weights():
    r = np.random.default_rng(17)
    conv_w = r.integers(-1, 2, size=(2, 1, 2, 2)).astype(np.float64)
    head_w = np.zeros((8, 2))
    head_w[1, 0], head_w[5, 0] = 1, -1
    head_w[2, 1], head_w[6, 1] = 1, 1
    return conv_w, head_w


def test_qat_lowering_same_layers(carried):
    data = _qat_cnn(*_qat_weights())
    jnet, jio = jqat.onnx_qat_to_fhe(data, jp.TOY_SHORTINT, in_hw=(3, 3))
    tnet, tio = tqat.onnx_qat_to_fhe(data, tp.TOY_SHORTINT, in_hw=(3, 3), device="cpu")
    assert tio == jio
    assert [type(l).__name__ for l in tnet.layers] == [type(l).__name__ for l in jnet.layers]
    for tl, jl in zip(tnet.layers, jnet.layers):
        for attr in ("w", "wmat", "idx", "b"):
            if getattr(jl, attr, None) is not None:
                np.testing.assert_array_equal(getattr(tl, attr), getattr(jl, attr))
    jnet.compile(input_hi=1)
    tnet.compile(input_hi=1)
    assert [getattr(l, "offset", None) for l in tnet.layers] == [getattr(l, "offset", None) for l in jnet.layers]
    for tl, jl in zip(tnet._luts, jnet._luts):
        _same_bits(tl, jl)


def test_run_qat_fhe_matches_reference(carried):
    data = _qat_cnn(*_qat_weights())
    x = np.random.default_rng(6).integers(0, 2, size=(2, 1, 3, 3)).astype(np.float64)
    jgot, jwant = jqat.run_qat_fhe(data, jp.TOY_SHORTINT, x, in_hw=(3, 3), seed=11)
    tgot, twant = tqat.run_qat_fhe(data, tp.TOY_SHORTINT, x, in_hw=(3, 3), seed=11, device="cpu")
    np.testing.assert_array_equal(twant, jwant)
    np.testing.assert_array_equal(tgot, jgot)
    np.testing.assert_array_equal(tgot, twant)


def test_tlu_layer_is_one_batched_pbs(monkeypatch):
    """One apply_lut a TLU layer over the whole (B, O, n+1) tensor, and at
    a level-1 k=1 key one fused rotation over all B*O ciphertexts (the
    single K3 launch on the card). The port's own keys."""
    params = dataclasses.replace(
        tp.TOY_SHORTINT, name="FUSED_TEST", lwe_dimension=12, polynomial_size=256,
        pbs=tp.GadgetParams(base_log=23, level=1),
    )
    calls, rotations = [], []
    apply_lut, fused = tfp.si.apply_lut, tbt._blind_rotate_fused

    def count_apply(sk, c, lut, deg):
        calls.append(tuple(c.ct.shape))
        return apply_lut(sk, c, lut, deg)

    def count_fused(acc, *args, **kw):
        rotations.append(tuple(acc.shape))
        return fused(acc, *args, **kw)

    monkeypatch.setattr(tfp.si, "apply_lut", count_apply)
    monkeypatch.setattr(tbt, "_blind_rotate_fused", count_fused)
    w = np.array([[1, 0, 1], [0, 1, 1]])
    net = tfp.FheSequential([tfp.FheLinear(w), tfp.FheTlu(relu_q)], params, seed=3, device="cpu").compile(input_hi=1)
    x = np.array([[0, 1], [1, 1], [1, 0], [0, 0], [1, 1]])
    got = net.decrypt(net.run(net.encrypt(x)))
    np.testing.assert_array_equal(got, net.clear_forward(x))
    assert calls == [(5, 3, params.big_lwe_dimension + 1)]
    assert rotations == [(5, 3, 2, 256)]


@pytest.mark.parametrize(
    "max_abs,k,cuda,ok",
    [(127, 25, True, True), (128, 25, True, False), (128, 25, False, True), (2**20, 2**8, False, False)],
    ids=["int8_edge", "over_int8_on_cuda", "over_int8_on_cpu", "int32_sums"],
)
def test_limb_operand_guard(max_abs, k, cuda, ok):
    if ok:
        check_limb_lhs(max_abs, k, cuda)
    else:
        with pytest.raises(ValueError, match="limb product"):
            check_limb_lhs(max_abs, k, cuda)


def test_linear_layer_raises_on_an_int32_overflow():
    c, n1 = 4, tp.TOY_SHORTINT.big_lwe_dimension + 1
    x = tfp.FheTensor(ct=torch.zeros((1, c, n1), dtype=torch.int64), params=tp.TOY_SHORTINT, degree=0)
    with pytest.raises(ValueError, match="int32"):
        tfp.FheLinear(np.full((c, 1), 2**26)).forward(x)
