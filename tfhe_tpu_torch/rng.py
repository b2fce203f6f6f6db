"""Deterministic randomness for key generation and noise sampling.

`FheRng` is the counter-based threefry2x32 generator of JAX's `jax.random`
(the default implementation, with `jax_threefry_partitionable` on), written
in plain torch: `FheRng(seed)` gives the same keys, masks and noise as
`tfhe_tpu.rng.FheRng(seed)`, bit for bit, after any sequence of `split`
and `fork` (`gaussian_torus` up to the last bit of erfinv). A key is a
pair of 32-bit words held on the host; `split` and `fork` hash it there.
The bulk draws hash (key, element index) on the FheRng's device, so the
card draws its own masks and the same seed gives the same values on the
CPU and on the card. 32-bit words are carried in int64 lanes with
explicit masks, because torch's uint32 lacks add, shift and compare on
the CPU.

Security note: in deployment the seed must come from an OS CSPRNG.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

from tfhe_tpu_torch import _device
from tfhe_tpu_torch.params import NoiseDistribution

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_CHUNK = 1 << 22  # elements hashed per pass; bounds the int64 temporaries


def _threefry2x32(k1: int, k2: int, x0, x1):
    """Threefry-2x32 with 20 rounds (JAX's `_threefry2x32_lowering`).

    The key words are ints; x0, x1 are ints or int64 tensors of 32-bit
    words. Returns the two hashed words in the same form."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _seed_key(seed: int) -> tuple[int, int]:
    """jax.random.key(seed): the 64-bit seed's high and low words."""
    if not -(2**63) <= seed < 2**63:
        raise OverflowError(f"seed {seed} does not fit in int64")
    s = seed % 2**64
    return s >> 32, s & _M32


def _split(key: tuple[int, int], num: int) -> list[tuple[int, int]]:
    """jax.random.split(key, num): child i hashes the counter (0, i)."""
    return [_threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def _bits_words(key: tuple[int, int], shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The two hashed words of every element: counter = the flat index."""
    size = math.prod(shape)
    hi = torch.empty(size, dtype=torch.int64, device=device)
    lo = torch.empty(size, dtype=torch.int64, device=device)
    for start in range(0, size, _CHUNK):
        idx = torch.arange(start, min(start + _CHUNK, size), dtype=torch.int64, device=device)
        hi[start : start + idx.numel()], lo[start : start + idx.numel()] = _threefry2x32(
            key[0], key[1], idx >> 32, idx & _M32
        )
    return hi.reshape(shape), lo.reshape(shape)


class FheRng:
    """A splittable deterministic RNG handle; sampling order is the
    reproducibility contract. Each draw consumes a fresh subkey; a lock
    makes the key step atomic, so threads sharing one FheRng never draw
    the same subkey. `device` is where samples are drawn (default "cuda",
    as every entry point; pass "cpu" to run without a card)."""

    def __init__(self, seed_or_key, device=None):
        if isinstance(seed_or_key, (int, np.integer)):
            self._key = _seed_key(int(seed_or_key))
        else:
            k1, k2 = (int(w) for w in np.asarray(seed_or_key).reshape(2))
            self._key = (k1 & _M32, k2 & _M32)
        self.device = _device.resolve(device)
        self._lock = threading.Lock()

    @property
    def key(self) -> tuple[int, int]:
        """The current key, as `jax.random.key_data` gives it."""
        return self._key

    def split(self, n: int = 2) -> list["FheRng"]:
        """n children; this handle keeps the first of n + 1 split keys."""
        with self._lock:
            keys = _split(self._key, n + 1)
            self._key = keys[0]
        return [FheRng(k, self.device) for k in keys[1:]]

    def _next(self) -> tuple[int, int]:
        with self._lock:
            self._key, sub = _split(self._key, 2)
        return sub

    def fork(self) -> "FheRng":
        return FheRng(self._next(), self.device)

    # -- samplers ----------------------------------------------------------

    def uniform_torus(self, shape) -> torch.Tensor:
        """Uniform u64 torus elements (ciphertext masks): bits(uint64)."""
        hi, lo = _bits_words(self._next(), tuple(shape), self.device)
        return (hi << 32) | lo

    def binary(self, shape) -> torch.Tensor:
        """Uniform bits in {0, 1} (binary secret keys): bits(uint32) & 1."""
        hi, lo = _bits_words(self._next(), tuple(shape), self.device)
        return (hi ^ lo) & 1

    def tuniform(self, bound_log2: int, shape) -> torch.Tensor:
        """TUniform(b) noise as u64 two's complement.

        r uniform on b+2 bits (the top bits of a u64 draw), then
        ((r + 1) >> 1) - 2^b: interior values have probability 2^-(b+1),
        the two bounds 2^-(b+2)."""
        b = bound_log2
        if not 0 <= b <= 61:
            raise ValueError(f"TUniform bound 2^{b} out of range")
        hi, lo = _bits_words(self._next(), tuple(shape), self.device)
        r = ((hi << 32) | lo) >> (64 - (b + 2))
        r = r & ((1 << (b + 2)) - 1)  # the arithmetic shift's sign bits
        return (r >> 1) + (r & 1) - (1 << b)  # (r + 1) >> 1 without overflow at b = 61

    def gaussian_torus(self, std_fraction: float, shape) -> torch.Tensor:
        """Centered gaussian with std = std_fraction * 2^64, rounded.

        jax.random.normal's float64 path: u uniform on (nextafter(-1, 0), 1)
        from the top 52 bits of a u64 draw, then sqrt(2) * erfinv(u). torch's
        erfinv may differ from XLA's in the last bit, so a sample may differ
        from the JAX package's by one after rounding."""
        hi, lo = _bits_words(self._next(), tuple(shape), self.device)
        mant = (((hi << 32) | lo) >> 12) & ((1 << 52) - 1)
        one = 0x3FF0000000000000
        f = (mant | one).view(torch.float64) - 1.0
        lo_v = float(np.nextafter(-1.0, 0.0))
        u = torch.clamp_min(f * (1.0 - lo_v) + lo_v, lo_v)
        g = math.sqrt(2) * torch.erfinv(u)
        return torch.round(g * (std_fraction * 2.0**64)).to(torch.int64)

    def noise(self, dist: NoiseDistribution, shape) -> torch.Tensor:
        if dist.kind == "zero":
            return torch.zeros(tuple(shape), dtype=torch.int64, device=self.device)
        if dist.kind == "tuniform":
            return self.tuniform(dist.bound_log2, shape)
        if dist.kind == "gaussian":
            return self.gaussian_torus(dist.std, shape)
        raise ValueError(dist.kind)
