"""Unsigned 64- and 32-bit arithmetic on int64 tensors.

Torus values are carried as int64 tensors holding u64 bit patterns:
two's-complement add, subtract and multiply already wrap mod 2^64, which
is the torus arithmetic. What differs between signed and unsigned lives
here: logical right shift, unsigned compare, unsigned division and
remainder by a constant. (PyTorch's uint64/uint32 dtypes lack add, shift
and compare on the CPU, so they are not used.)

u32 values (NTT residues, Shoup companions) are computed on int64 lanes
in [0, 2^32) and stored as int32 bit patterns (`to_i32` / `u32`).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_MIN64 = -(2**63)


def const(v: int) -> int:
    """A Python int in [0, 2^64) (or any int, taken mod 2^64) as the
    signed int64 value with the same bit pattern."""
    v %= 2**64
    return v - 2**64 if v >= 2**63 else v


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of u64 bit patterns by a constant 0 <= k < 64."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b."""
    if not isinstance(b, torch.Tensor):
        b = const(int(b))
    return (a ^ _MIN64) < (b ^ _MIN64)


def _udivmod(x: torch.Tensor, d: int):
    assert 0 < d < 2**64
    if d & (d - 1) == 0:
        k = d.bit_length() - 1
        return srl(x, k), x & (d - 1)
    assert d < 2**31, "unsigned division by a non-power-of-two needs d < 2^31"
    hi = srl(x, 32)
    lo = x & MASK32
    qh = hi // d
    rh = hi - qh * d
    t = (rh << 32) | lo  # < d * 2^32 < 2^63
    ql = t // d
    return (qh << 32) + ql, t - ql * d


def udiv(x: torch.Tensor, d: int) -> torch.Tensor:
    """Unsigned x // d for a constant d."""
    return _udivmod(x, d)[0]


def umod(x: torch.Tensor, d: int) -> torch.Tensor:
    """Unsigned x % d for a constant d."""
    return _udivmod(x, d)[1]


def u32(x: torch.Tensor) -> torch.Tensor:
    """u32 bit patterns (any integer tensor) as int64 values in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 tensors with the same bits."""
    return (((x & MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def trunc_i32(x: torch.Tensor) -> torch.Tensor:
    """Wrap an integer tensor to the int32 range (C-style truncation),
    returned as int64."""
    return ((x.to(torch.int64) + 2**31) & MASK32) - 2**31


def mulhi_u32(a: torch.Tensor, b) -> torch.Tensor:
    """High 32 bits of the 64-bit product of u32 operands (int64 lanes)."""
    return srl(a * b, 32)


def shoup_mulmod(a: torch.Tensor, w, w_shoup, p: int) -> torch.Tensor:
    """a * w mod p for any u32 a and w < p with w_shoup = floor(w*2^32/p);
    a lazy residue in [0, 2p). All operands are int64 lanes."""
    q = mulhi_u32(a, w_shoup)
    return a * w - q * p


def condsub(x: torch.Tensor, m) -> torch.Tensor:
    return torch.where(x >= m, x - m, x)


def u64_from_numpy(a) -> torch.Tensor:
    """numpy uint64 array -> int64 tensor with the same bits."""
    import numpy as np

    return torch.from_numpy(np.array(a, dtype=np.uint64).view(np.int64))


def u64_to_numpy(x: torch.Tensor):
    """int64 tensor -> numpy uint64 array with the same bits."""
    import numpy as np

    return x.detach().cpu().numpy().astype(np.int64).view(np.uint64)
