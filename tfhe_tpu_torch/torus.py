"""Discretized-torus arithmetic on int64 tensors carrying u64 bits.

The torus is discretized to q = 2^64 levels; additions, subtractions and
integer scaling are plain wrapping int64 ops. This module holds the
non-trivial primitives: delta encode/decode, the balanced (signed) gadget
decomposition with round-to-closest (tfhe-rs SignedDecomposer semantics),
modulus switching and negacyclic monomial rotation. Every shift and
division that must be unsigned goes through `_u64`.

Counterpart of tfhe_tpu/torus.py; bit-exact with it (tests/test_torch_port_torus.py).
"""

from __future__ import annotations

import torch

from tfhe_tpu_torch import _u64
from tfhe_tpu_torch.params import GadgetParams

Q_BITS = 64


def encode(msg, delta: int) -> torch.Tensor:
    """msg * delta on the torus (wraps)."""
    return torch.as_tensor(msg).to(torch.int64) * _u64.const(delta)


def decode(pt: torch.Tensor, delta: int, modulus: int) -> torch.Tensor:
    """Round to the nearest multiple of delta and reduce mod `modulus`
    (unsigned arithmetic throughout)."""
    rounded = _u64.udiv(pt + _u64.const(delta // 2), delta)
    return _u64.umod(_u64.umod(rounded, (2**Q_BITS) // delta), modulus)


def decode_signed(pt: torch.Tensor, delta: int, modulus: int) -> torch.Tensor:
    """Decode into the centered range [-modulus/2, modulus/2)."""
    v = decode(pt, delta, modulus)
    return v - torch.where(v >= modulus // 2, modulus, 0)


def round_to_msb(x: torch.Tensor, msb: int) -> torch.Tensor:
    """Round x to the closest multiple of 2^(64-msb); returns the msb-bit
    integer (wraps to 0 at the top, correct mod q)."""
    shift = Q_BITS - msb
    half = _u64.const(1 << (shift - 1)) if msb < Q_BITS else 0
    return _u64.srl(x + half, shift)


def signed_decompose(x: torch.Tensor, gadget: GadgetParams) -> torch.Tensor:
    """Balanced gadget decomposition; digits (u64 two's complement of
    values in [-B/2, B/2)) stacked on a new trailing axis of size
    `level`, most significant first:
    sum_i digits[..., i] * 2^(64 - (i+1)*base_log) == round(x)  (mod q)."""
    b = gadget.base_log
    l = gadget.level
    base = 1 << b
    half = 1 << (b - 1)
    state = round_to_msb(x, l * b)
    digits = []
    for _ in range(l):
        d = state & (base - 1)
        state = _u64.srl(state, b)
        carry = (d >= half).to(torch.int64)
        d = d - carry * base
        state = state + carry
        digits.append(d)
    digits.reverse()
    return torch.stack(digits, dim=-1)


def recompose(digits: torch.Tensor, gadget: GadgetParams) -> torch.Tensor:
    """Inverse of signed_decompose up to rounding."""
    b, l = gadget.base_log, gadget.level
    acc = torch.zeros(digits.shape[:-1], dtype=torch.int64, device=digits.device)
    for i in range(l):
        acc = acc + (digits[..., i] << (Q_BITS - (i + 1) * b))
    return acc


def mod_switch(x: torch.Tensor, log2_target: int) -> torch.Tensor:
    """Switch x from mod 2^64 to mod 2^log2_target with rounding."""
    return round_to_msb(x, log2_target) & ((1 << log2_target) - 1)


def negacyclic_monomial_rotate(poly: torch.Tensor, r) -> torch.Tensor:
    """Multiply polynomial(s) by X^r in Z_q[X]/(X^N + 1).

    poly: (..., N); r broadcastable to poly.shape[:-1], exponents taken
    mod 2N. A gather: out[i] = x[(i - r) mod 2N] where an index >= N
    reads x[index - N] negated (the same function as the JAX barrel
    rotation)."""
    n = poly.shape[-1]
    r = torch.as_tensor(r, device=poly.device).to(torch.int64)
    batch = torch.broadcast_shapes(poly.shape[:-1], r.shape)
    x = poly.expand(*batch, n)
    r = r.expand(batch)
    i = torch.arange(n, device=poly.device)
    idx = (i - r[..., None]) % (2 * n)  # (..., N) in [0, 2N)
    neg = idx >= n
    vals = torch.gather(x, -1, torch.where(neg, idx - n, idx))
    return torch.where(neg, -vals, vals)
