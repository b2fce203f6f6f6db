"""Compact public-key encryption (counterpart of
tfhe_tpu/api/public_key.py).

Role of the reference's TfheCompactPublicKey / CompactCiphertextList
(reference: sdk/relayer/src/tfhe.ts createTfhePublicKey,
sdk/encrypt.ts:54-196 packing <=256 values / <=2048 bits into one list):
clients encrypt inputs WITHOUT the secret key.

Construction: the classic LWE public key -- M zero-encryptions under the
big key; encrypt(mu) = r . PK + (0, ..., 0, mu + e) with fresh binary r per
value. Batched: a whole input list encrypts as one (values, M) x (M, n+1)
u64 contraction (`binary_combination`).
"""

from __future__ import annotations

import dataclasses

import torch

from tfhe_tpu_torch.core.lwe import encrypt_lwe, limb_product, limb_rhs
from tfhe_tpu_torch.models.shortint import ClientKey
from tfhe_tpu_torch.params import ShortintParams
from tfhe_tpu_torch.rng import FheRng
from tfhe_tpu_torch.torus import encode


@dataclasses.dataclass
class CompactPublicKey:
    zeros: torch.Tensor  # (M, big_n+1) zero-encryptions under the big key
    params: ShortintParams


def binary_combination(r: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """r (..., M) in {0, 1} times rows (M, W) of u64 bits, mod 2^64 ->
    (..., W). The JAX package's scheme: sixteen 4-bit limbs of the rows,
    each contracted with r (sums below M * 15 < 2^31), recombined with
    wrapping shifts, as one `core.lwe.limb_product` (torch._int_mm on the
    card, where there is no 64-bit matmul)."""
    m, w = rows.shape
    prod = limb_product(r.reshape(-1, m), limb_rhs(rows), w, 1)
    return prod.reshape(*r.shape[:-1], w)


def gen_public_key(ck: ClientKey, rng: FheRng, n_rows: int | None = None) -> CompactPublicKey:
    """M = n_rows (default big_n + 128) zero-encryptions under the big key,
    on the client key's device."""
    p = ck.params
    if n_rows is None:
        n_rows = p.big_lwe_dimension + 128
    zeros = encrypt_lwe(
        ck.big_lwe_key,
        torch.zeros((n_rows,), dtype=torch.int64, device=ck.device),
        rng,
        p.glwe_noise,
    )
    return CompactPublicKey(zeros=zeros, params=p)


def pk_encrypt_blocks(pk: CompactPublicKey, block_values, rng: FheRng) -> torch.Tensor:
    """block_values: (...,) plaintext block values (already < msg_mod) ->
    LWE cts (..., big_n+1) encoded at the shortint delta, on the key's
    device. Draw order: r, then the noise."""
    p = pk.params
    m = pk.zeros.shape[0]
    vals = torch.as_tensor(block_values, device=pk.zeros.device).to(torch.int64)
    r = rng.binary(tuple(vals.shape) + (m,)).to(pk.zeros.device)
    ct = binary_combination(r, pk.zeros)
    e = rng.noise(p.glwe_noise, tuple(vals.shape)).to(pk.zeros.device)
    ct[..., -1] += encode(vals, p.delta) + e
    return ct
