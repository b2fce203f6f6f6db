"""Deterministic randomness for key generation and noise sampling.

`FheRng` draws from an explicit CPU `torch.Generator` seeded by one
integer and moves the samples to the requested device, so the same seed
gives the same keys on the CPU and on the card. It cannot reproduce the
JAX threefry stream of tfhe_tpu.rng; tests that compare the two packages
bit for bit carry keys across with `tfhe_tpu_torch.convert`.

Security note: in deployment the seed must come from an OS CSPRNG.
"""

from __future__ import annotations

import torch

from tfhe_tpu_torch import _device, _u64
from tfhe_tpu_torch.params import NoiseDistribution


class FheRng:
    """Seeded sampler handle; sampling order is the reproducibility
    contract. `device` is where samples are returned (default "cuda",
    as every entry point; pass "cpu" to run without a card)."""

    def __init__(self, seed: int, device=None):
        self._gen = torch.Generator(device="cpu")
        self._gen.manual_seed(int(seed))
        self.device = _device.resolve(device)

    def _u32(self, shape) -> torch.Tensor:
        return torch.randint(0, 2**32, tuple(shape), generator=self._gen, dtype=torch.int64)

    # -- samplers ----------------------------------------------------------

    def uniform_torus(self, shape) -> torch.Tensor:
        """Uniform u64 torus elements; each from two 32-bit draws."""
        hi = self._u32(shape)
        lo = self._u32(shape)
        return ((hi << 32) | lo).to(self.device)

    def binary(self, shape) -> torch.Tensor:
        """Uniform bits in {0, 1} (binary secret keys)."""
        return (self._u32(shape) & 1).to(self.device)

    def tuniform(self, bound_log2: int, shape) -> torch.Tensor:
        """TUniform(b): r uniform on b+2 bits, ((r + 1) >> 1) - 2^b, as u64
        two's complement."""
        b = bound_log2
        if not 0 <= b <= 61:
            raise ValueError(f"TUniform bound 2^{b} out of range")
        r = _u64.srl(self.uniform_torus(shape), 64 - (b + 2))
        return ((r + 1) >> 1) - (1 << b)

    def gaussian_torus(self, std_fraction: float, shape) -> torch.Tensor:
        """Centered gaussian with std = std_fraction * 2^64, rounded."""
        g = torch.randn(tuple(shape), generator=self._gen, dtype=torch.float64)
        return torch.round(g * (std_fraction * 2.0**64)).to(torch.int64).to(self.device)

    def noise(self, dist: NoiseDistribution, shape) -> torch.Tensor:
        if dist.kind == "zero":
            return torch.zeros(tuple(shape), dtype=torch.int64, device=self.device)
        if dist.kind == "tuniform":
            return self.tuniform(dist.bound_log2, shape)
        if dist.kind == "gaussian":
            return self.gaussian_torus(dist.std, shape)
        raise ValueError(dist.kind)
