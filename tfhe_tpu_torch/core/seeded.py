"""Seeded and modulus-switched (compressed) GLWE storage (counterpart of
tfhe_tpu/core/seeded.py).

A ciphertext's masks are pseudorandom, so a seeded ciphertext stores the
bodies and the seed, and the masks regenerate from (seed, shape). The port's
FheRng is the JAX package's threefry stream, so a seeded ciphertext of
either package expands in the other to the same masks. The compressed
form switches a ciphertext to a storage modulus 2^log2_modulus <= 2^32 and
keeps the payload as int32 bit patterns (torch has no u32 arithmetic on
the CPU); its wire format is the JAX package's,
byte for byte: a header (log2_modulus, ndim, the dims as u32 little-endian)
and the values bit-packed LSB first at log2_modulus bits each.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tfhe_tpu_torch import _device, _u64
from tfhe_tpu_torch.core.glwe import mask_times_key
from tfhe_tpu_torch.core.keys import GlweSecretKey, glwe_key_ntt
from tfhe_tpu_torch.params import NoiseDistribution
from tfhe_tpu_torch.rng import FheRng
from tfhe_tpu_torch.torus import mod_switch

NOISE_SEED_XOR = 0x5EEDED  # the noise stream's seed is seed ^ this


@dataclasses.dataclass
class SeededGlweCiphertext:
    """bodies: (..., N) int64; the masks regenerate from `seed`."""

    bodies: torch.Tensor
    seed: int
    k: int


def encrypt_glwe_seeded(
    sk: GlweSecretKey, pt: torch.Tensor, seed: int, noise: NoiseDistribution, engine
) -> SeededGlweCiphertext:
    """Encrypt (..., N) plaintext polynomials, keeping bodies and seed."""
    dev = pt.device
    batch = tuple(pt.shape[:-1])
    n = pt.shape[-1]
    mask = FheRng(seed, dev).uniform_torus(batch + (sk.k, n))
    e = FheRng(seed ^ NOISE_SEED_XOR, dev).noise(noise, batch + (n,))
    body = pt.to(torch.int64) + e + mask_times_key(mask, glwe_key_ntt(sk, engine), engine)
    return SeededGlweCiphertext(bodies=body, seed=seed, k=sk.k)


def expand_seeded_glwe(ct: SeededGlweCiphertext) -> torch.Tensor:
    """Regenerate the masks: the GLWE tensor (..., k+1, N)."""
    batch = tuple(ct.bodies.shape[:-1])
    n = ct.bodies.shape[-1]
    mask = FheRng(ct.seed, ct.bodies.device).uniform_torus(batch + (ct.k, n))
    return torch.cat([mask, ct.bodies[..., None, :]], dim=-2)


@dataclasses.dataclass
class CompressedGlweCiphertext:
    """Modulus-switched storage: int32 bit patterns of u32 values below
    2^log2_modulus."""

    data: torch.Tensor
    log2_modulus: int


def compress_glwe(ct: torch.Tensor, log2_modulus: int) -> CompressedGlweCiphertext:
    if not 1 <= log2_modulus <= 32:
        raise ValueError(f"storage modulus 2^{log2_modulus} outside 2^1 .. 2^32")
    return CompressedGlweCiphertext(data=_u64.to_i32(mod_switch(ct, log2_modulus)), log2_modulus=log2_modulus)


def decompress_glwe(c: CompressedGlweCiphertext) -> torch.Tensor:
    """Back to q = 2^64 (the rounding error is extra noise)."""
    return _u64.u32(c.data) << (64 - c.log2_modulus)


def bitpack(vals: np.ndarray, bits: int) -> bytes:
    """Dense LSB-first packing of u32 values at `bits` bits each, the
    value i at bits [i*bits, (i+1)*bits) of a little-endian bit string."""
    if not 1 <= bits <= 32:
        raise ValueError(f"bit width {bits} outside 1 .. 32")
    v = np.ascontiguousarray(vals, dtype=np.uint32).reshape(-1)
    planes = (v[:, None] >> np.arange(bits, dtype=np.uint32)) & np.uint32(1)
    return np.packbits(planes.astype(np.uint8).reshape(-1), bitorder="little").tobytes()


def bitunpack(data: bytes, bits: int, count: int) -> np.ndarray:
    """Inverse of bitpack: `count` u32 values of `bits` bits each."""
    if not 1 <= bits <= 32:
        raise ValueError(f"bit width {bits} outside 1 .. 32")
    flat = np.unpackbits(np.frombuffer(data, dtype=np.uint8), bitorder="little")
    if flat.size < count * bits:
        raise ValueError(f"{len(data)} bytes hold fewer than {count} values of {bits} bits")
    planes = flat[: count * bits].reshape(count, bits).astype(np.uint64)
    return (planes << np.arange(bits, dtype=np.uint64)).sum(axis=1).astype(np.uint32)


def pack_compressed_glwe(c: CompressedGlweCiphertext) -> bytes:
    data = c.data.detach().cpu().numpy().view(np.uint32)
    header = bytes([c.log2_modulus, data.ndim]) + b"".join(int(d).to_bytes(4, "little") for d in data.shape)
    return header + bitpack(data, c.log2_modulus)


def unpack_compressed_glwe(blob: bytes, device=None) -> CompressedGlweCiphertext:
    """The payload on `device` (default "cuda")."""
    device = _device.resolve(device)
    log2_m, ndim = blob[0], blob[1]
    shape = tuple(int.from_bytes(blob[2 + 4 * i : 6 + 4 * i], "little") for i in range(ndim))
    vals = bitunpack(blob[2 + 4 * ndim :], log2_m, int(np.prod(shape)))
    data = torch.from_numpy(vals.reshape(shape).view(np.int32).copy()).to(device)
    return CompressedGlweCiphertext(data=data, log2_modulus=log2_m)
