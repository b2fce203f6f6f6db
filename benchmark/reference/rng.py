"""The counter-based threefry2x32 generator that the measured program draws
its keys from (JAX's `jax.random` with `jax_threefry_partitionable`),
frozen here in plain torch so that the reference can work the keys out
again from the seed alone.

Only what key generation uses is kept: `split`, the subkey step, and the
uniform, binary and TUniform samplers. A key is a pair of 32-bit words on
the host; a bulk draw hashes (key, element index) on the given device.
32-bit words ride in int64 lanes with explicit masks.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_CHUNK = 1 << 22  # elements hashed per pass


def threefry2x32(k1: int, k2: int, x0, x1):
    """Threefry-2x32, 20 rounds. Key words are ints; x0, x1 are ints or
    int64 tensors of 32-bit words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _split(key: tuple[int, int], num: int) -> list[tuple[int, int]]:
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def _words(key: tuple[int, int], shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    size = math.prod(shape)
    hi = torch.empty(size, dtype=torch.int64, device=device)
    lo = torch.empty(size, dtype=torch.int64, device=device)
    for start in range(0, size, _CHUNK):
        idx = torch.arange(start, min(start + _CHUNK, size), dtype=torch.int64, device=device)
        h, l = threefry2x32(key[0], key[1], idx >> 32, idx & M32)
        hi[start:start + idx.numel()] = h
        lo[start:start + idx.numel()] = l
    return hi.reshape(shape), lo.reshape(shape)


class KeyRng:
    """Seeded draws in the program's order: each draw takes a fresh subkey."""

    def __init__(self, seed: int, device):
        if not -(2**63) <= seed < 2**63:
            raise OverflowError(f"seed {seed} does not fit in int64")
        s = seed % 2**64
        self.key = (s >> 32, s & M32)
        self.device = device

    def _next(self) -> tuple[int, int]:
        self.key, sub = _split(self.key, 2)
        return sub

    def uniform_u64(self, shape) -> torch.Tensor:
        hi, lo = _words(self._next(), tuple(shape), self.device)
        return (hi << 32) | lo

    def binary(self, shape) -> torch.Tensor:
        hi, lo = _words(self._next(), tuple(shape), self.device)
        return (hi ^ lo) & 1

    def tuniform(self, b: int, shape) -> torch.Tensor:
        """TUniform(2^b) as u64 two's complement: r on b + 2 bits,
        ((r + 1) >> 1) - 2^b."""
        hi, lo = _words(self._next(), tuple(shape), self.device)
        r = (((hi << 32) | lo) >> (64 - (b + 2))) & ((1 << (b + 2)) - 1)
        return (r >> 1) + (r & 1) - (1 << b)
