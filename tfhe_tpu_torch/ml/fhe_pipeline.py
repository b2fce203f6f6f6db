"""End-to-end FHE inference: every layer server-side, zero client-side
nonlinearities (counterpart of tfhe_tpu/ml/fhe_pipeline.py).

The full-FHE path of concrete-ml's EXECUTE mode (reference:
ml/concrete-ml/src/concrete/ml/quantization/quantized_module.py forward
under FheMode.EXECUTE runs the whole circuit, TLUs included, under FHE;
torch/compile.py:282): the client encrypts ONCE, the server runs linear
layers as exact LWE linear combinations of clear quantized weights and
every nonlinearity as a programmable bootstrap, and the client decrypts
ONCE at the end.

On the card a linear layer is one `core/lwe.limb_product` (CUDA has no
64-bit matmul): the clear weights are the small int8 left operand, the
ciphertexts the 16-limb right-hand side. A TLU layer is one
`models/shortint.apply_lut` over the whole (..., O, n+1) tensor, so one
launch of the rotation kernel (K3 at a classic level-1 k=1 key, K4 at a
multi-bit key) bootstraps every value of the layer.

Accumulator discipline (the concrete-ml "accumulator bit-width"
constraint, post_training.py): a linear combination sum(w * x) of
shortint ciphertexts must stay inside the msg*carry plaintext space
(16 values at 2_2 params) before the next PBS re-quantizes it. compile()
checks this per layer from the calibrated ranges and raises
AccumulatorOverflow when violated.

Signed accumulators use offset encoding: the TLU table is shifted so
acc + offset lands in [0, space); the offset is added to the body.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from tfhe_tpu_torch import _u64
from tfhe_tpu_torch.core.lwe import limb_product, limb_rhs, lwe_add_plain
from tfhe_tpu_torch.models import shortint as si
from tfhe_tpu_torch.params import ShortintParams
from tfhe_tpu_torch.rng import FheRng


class AccumulatorOverflow(ValueError):
    pass


@dataclasses.dataclass
class FheTensor:
    """Batched LWE ciphertexts holding small ints: ct (..., n+1) int64,
    each row encrypting one value in [0, space)."""

    ct: torch.Tensor
    params: ShortintParams
    degree: int  # max plaintext value (concrete-ml degree tracking)

    @property
    def shape(self):
        return self.ct.shape[:-1]


def _space(p: ShortintParams) -> int:
    return p.message_modulus * p.carry_modulus


def _clear_times_lwe(w_ok: np.ndarray, rows: torch.Tensor) -> torch.Tensor:
    """sum_k w_ok[o, k] * rows[k] mod 2^64 for a clear integer (O, K)
    matrix and K ciphertext rows (K, ..., n+1) -> (O, ..., n+1): one
    `limb_product`, the ciphertexts as its 16-limb right-hand side. Raises
    for weights the product cannot hold exactly (`core/lwe.check_limb_lhs`)."""
    flat = rows.reshape(rows.shape[0], -1)
    lhs = torch.from_numpy(np.ascontiguousarray(w_ok, dtype=np.int64)).to(rows.device)
    out = limb_product(lhs, limb_rhs(flat), flat.shape[1], int(np.abs(w_ok).max(initial=0)))
    return out.reshape(w_ok.shape[0], *rows.shape[1:])


def _add_bias(acc: torch.Tensor, b: np.ndarray, delta: int) -> torch.Tensor:
    """acc[..., o, -1] += b[o] * delta mod 2^64 (two's complement int64)."""
    enc_b = torch.tensor([_u64.const(int(v) * delta) for v in b], dtype=torch.int64, device=acc.device)
    return lwe_add_plain(acc, enc_b)


class FheLinear:
    """y = x @ w (+ b): EXACT linear combination of LWE ciphertexts with
    clear integer weights -- no PBS, no noise refresh. Weights must be
    small signed ints (ternary / few-bit); compile() checks the
    accumulator range."""

    def __init__(self, w_int: np.ndarray, b_int: np.ndarray | None = None):
        self.w = np.asarray(w_int, dtype=np.int64)  # (C, O)
        self.b = None if b_int is None else np.asarray(b_int, dtype=np.int64)

    def clear_apply(self, v: np.ndarray) -> np.ndarray:
        out = v @ self.w
        return out if self.b is None else out + self.b

    def out_range(self, in_lo: int, in_hi: int) -> tuple[int, int]:
        wpos = np.maximum(self.w, 0).sum(axis=0)
        wneg = np.minimum(self.w, 0).sum(axis=0)
        lo = (wneg * in_hi + wpos * in_lo).min()
        hi = (wpos * in_hi + wneg * in_lo).max()
        if self.b is not None:
            lo += int(self.b.min())
            hi += int(self.b.max())
        return int(lo), int(hi)

    def forward(self, x: FheTensor) -> torch.Tensor:
        """(..., C, n+1) -> (..., O, n+1), wrapping mod 2^64."""
        acc = _clear_times_lwe(self.w.T, x.ct.movedim(-2, 0)).movedim(0, -2)
        return acc if self.b is None else _add_bias(acc, self.b, x.params.delta)


class FheTlu:
    """Elementwise nonlinearity as one programmable bootstrap per value.

    table_fn maps the true integer accumulator value to the next layer's
    quantized input in [0, space). Signed accumulators are offset into
    [0, space) and the offset is folded into the table."""

    def __init__(self, table_fn: Callable[[int], int]):
        self.table_fn = table_fn
        self.offset = 0  # set at compile time from the input range

    def make_lut(self, p: ShortintParams, device=None) -> torch.Tensor:
        space = _space(p)
        table = [int(self.table_fn(v - self.offset)) % space for v in range(space)]
        return si.generate_lut(p, np.asarray(table, dtype=np.uint64), device)


class FheSequential:
    """compile() -> run(encrypted) with no intermediate decrypts. The keys
    are generated on `device` (default "cuda")."""

    def __init__(self, layers: Sequence, params: ShortintParams, seed: int = 0, device=None):
        self.layers = list(layers)
        self.params = params
        self.ck, self.sk = si.keygen(params, seed=seed, device=device)
        self._luts = None
        self.input_range = (0, params.message_modulus - 1)

    @property
    def device(self) -> torch.device:
        return self.ck.device

    def compile(self, input_hi: int | None = None):
        """Walk calibrated ranges through the network; fit every TLU's
        offset; fail closed on accumulator overflow."""
        p = self.params
        space = _space(p)
        lo, hi = 0, input_hi if input_hi is not None else space - 1
        self._luts = []
        for i, layer in enumerate(self.layers):
            if isinstance(layer, FheLinear):
                lo, hi = layer.out_range(lo, hi)
                if hi - lo + 1 > space:
                    raise AccumulatorOverflow(
                        f"layer {i}: accumulator range [{lo}, {hi}] exceeds "
                        f"the {space}-value plaintext space; reduce weight "
                        f"magnitude or activation bits (the reference's "
                        f"n_bits / p_error search trades these off)"
                    )
            elif isinstance(layer, FheTlu):
                layer.offset = -lo
                self._luts.append(layer.make_lut(p, self.sk.device))
                # table outputs are the next layer's inputs
                outs = [int(layer.table_fn(v)) % space for v in range(lo, hi + 1)]
                lo, hi = min(outs), max(outs)
            else:
                raise TypeError(type(layer))
        self.output_range = (lo, hi)
        return self

    def encrypt(self, x_q: np.ndarray, seed: int = 99) -> FheTensor:
        """x_q: (..., C) ints in [0, input_hi]."""
        x_q = np.asarray(x_q, dtype=np.int64)
        ct = si.encrypt(self.ck, torch.from_numpy(x_q), FheRng(seed, self.device))
        return FheTensor(ct=ct.ct, params=self.params, degree=int(x_q.max()))

    def run_layers(self, x: FheTensor):
        """run() one layer at a time: yields (layer, ciphertexts after it).
        A TLU layer adds its offset to the bodies, then runs one batched
        PBS over the whole tensor."""
        if self._luts is None:
            raise RuntimeError("compile() first")
        p = self.params
        space = _space(p)
        ct = x.ct
        lut_i = 0
        for layer in self.layers:
            if isinstance(layer, FheLinear):
                ct = layer.forward(FheTensor(ct=ct, params=p, degree=0))
            else:
                if layer.offset:
                    ct = lwe_add_plain(ct, _u64.const(layer.offset * p.delta))
                wrapped = si.Ciphertext(ct=ct, params=p, degree=space - 1, noise_level=1)
                ct = si.apply_lut(self.sk, wrapped, self._luts[lut_i], space - 1).ct
                lut_i += 1
            yield layer, ct

    def run(self, x: FheTensor) -> FheTensor:
        """Server-side: every op on ciphertexts; NO decrypt anywhere."""
        ct = x.ct
        for _, ct in self.run_layers(x):
            pass
        return FheTensor(ct=ct, params=self.params, degree=_space(self.params) - 1)

    def decrypt(self, y: FheTensor) -> np.ndarray:
        space = _space(self.params)
        c = si.Ciphertext(ct=y.ct, params=self.params, degree=space - 1, noise_level=1)
        return si.decrypt(self.ck, c).cpu().numpy().astype(np.int64)

    def clear_forward(self, x_q: np.ndarray) -> np.ndarray:
        """Integer reference pipeline (DISABLE mode): must match run()."""
        space = _space(self.params)
        v = np.asarray(x_q, dtype=np.int64)
        for layer in self.layers:
            if isinstance(layer, FheLinear):
                v = layer.clear_apply(v)
            else:
                v = np.vectorize(lambda t: int(layer.table_fn(t)) % space)(v)
        return v % space


class FheConv2d(FheLinear):
    """2-D convolution on ciphertexts: im2col GATHER of the input LWE
    blocks into patches (indexing, no crypto), then ONE exact linear
    contraction of every patch against the (Cout, Cin*kh*kw) kernel
    matrix, as one limb product over the patch axis (the reference
    lowers Conv to the same integer matmul, quantized_ops.py
    QuantizedConv), instead of conv2d_as_linear's sparse
    (Cin*H*W, Cout*oh*ow) matrix.

    Input layout: the FheTensor's value axis is the flattened (Cin, H, W)
    image; output value axis is flattened (Cout, oh, ow) -- the same
    channel-major order conv2d_as_linear produces, so heads chain
    identically."""

    def __init__(self, w_int: np.ndarray, in_hw: tuple, b_int: np.ndarray | None = None, stride: int = 1):
        cout, cin, kh, kw = np.asarray(w_int).shape
        h, wdt = in_hw
        oh = (h - kh) // stride + 1
        ow = (wdt - kw) // stride + 1
        self.wmat = np.asarray(w_int, np.int64).reshape(cout, cin * kh * kw)
        self.out_hw = (oh, ow)
        self.cout = cout
        # gather map: patch p = (y, x) -> flat indices of its K inputs
        idx = np.empty((oh * ow, cin * kh * kw), dtype=np.int64)
        for y in range(oh):
            for x in range(ow):
                k = 0
                for ci in range(cin):
                    for dy in range(kh):
                        for dx in range(kw):
                            idx[y * ow + x, k] = (ci * h + y * stride + dy) * wdt + x * stride + dx
                            k += 1
        self.idx = idx
        # per-output-channel bias broadcast over the oh*ow positions
        self.b = None
        if b_int is not None:
            self.b = np.repeat(np.asarray(b_int, np.int64), oh * ow)

    def clear_apply(self, v: np.ndarray) -> np.ndarray:
        out = np.einsum("...lk,ok->...ol", v[..., self.idx], self.wmat)
        out = out.reshape(*out.shape[:-2], -1)
        return out if self.b is None else out + self.b

    def out_range(self, in_lo: int, in_hi: int) -> tuple[int, int]:
        wpos = np.maximum(self.wmat, 0).sum(axis=1)
        wneg = np.minimum(self.wmat, 0).sum(axis=1)
        lo = int((wneg * in_hi + wpos * in_lo).min())
        hi = int((wpos * in_hi + wneg * in_lo).max())
        if self.b is not None:
            lo += int(self.b.min())
            hi += int(self.b.max())
        return lo, hi

    def forward(self, x: FheTensor) -> torch.Tensor:
        """(..., Cin*H*W, n+1) -> (..., Cout*oh*ow, n+1)."""
        ct = x.ct
        patches = ct[..., torch.from_numpy(self.idx).to(ct.device), :]  # (..., L, K, n+1)
        acc = _clear_times_lwe(self.wmat, patches.movedim(-2, 0))  # (Cout, ..., L, n+1)
        acc = acc.movedim(0, -3)
        acc = acc.reshape(*acc.shape[:-3], -1, acc.shape[-1])
        return acc if self.b is None else _add_bias(acc, self.b, x.params.delta)


def conv2d_as_linear(w: np.ndarray, in_hw: tuple, stride: int = 1) -> FheLinear:
    """Lower a (Cout, Cin, Kh, Kw) integer conv to an FheLinear over the
    flattened input (the im2col-free dense form; fine at small sizes --
    the reference lowers conv via onnx to matmul the same way)."""
    cout, cin, kh, kw = w.shape
    h, wdt = in_hw
    oh = (h - kh) // stride + 1
    ow = (wdt - kw) // stride + 1
    m = np.zeros((cin * h * wdt, cout * oh * ow), dtype=np.int64)
    for co in range(cout):
        for y in range(oh):
            for x in range(ow):
                o = (co * oh + y) * ow + x
                for ci in range(cin):
                    for dy in range(kh):
                        for dx in range(kw):
                            i = (ci * h + y * stride + dy) * wdt + x * stride + dx
                            m[i, o] = w[co, ci, dy, dx]
    return FheLinear(m)
