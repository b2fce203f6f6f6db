"""Threshold decryption: multi-party key shares and share recombination
(counterpart of tfhe_tpu/api/threshold.py).

Analog of the reference's threshold-KMS decryption path (reference:
sdk/relayer/src/relayer/userDecrypt.ts:209-246 -- n KMS parties each
partially decrypt and the client recombines shares via the TKMS WASM
client; local-dev/docker-compose.yml runs `-parties 5`). LWE decryption is
linear in the secret, so an additive n-of-n sharing gives an exact
protocol: party i holds s_i with sum_i s_i = s (mod q) and publishes
partial_i = <a, s_i> + e_flood_i; the combiner computes
b - sum_i partial_i and decodes.

Noise flooding: each party adds fresh TUniform noise so its partial leaks
nothing about s_i beyond the final plaintext (the standard smudging
argument). Shares and partials are int64 tensors of u64 bits, batched
like everything else: the partials of thousands of ciphertexts are one
product per party, on the device the ciphertexts are on.
"""

from __future__ import annotations

import dataclasses

import torch

from tfhe_tpu_torch.core.keys import LweSecretKey
from tfhe_tpu_torch.params import NoiseDistribution
from tfhe_tpu_torch.rng import FheRng
from tfhe_tpu_torch.torus import decode


@dataclasses.dataclass
class KeyShare:
    share: torch.Tensor  # (n,) u64 additive share of the secret key
    party: int
    n_parties: int


def share_secret_key(sk: LweSecretKey, n_parties: int, rng: FheRng) -> list[KeyShare]:
    """Split s into n additive shares over Z_q (u64 wraparound)."""
    shares = [rng.uniform_torus((sk.n,)).to(sk.key.device) for _ in range(n_parties - 1)]
    last = sk.key - sum(shares) if shares else sk.key
    shares.append(last)
    return [KeyShare(share=s, party=i, n_parties=n_parties) for i, s in enumerate(shares)]


def partial_decrypt(
    ct: torch.Tensor, share: KeyShare, rng: FheRng, flood: NoiseDistribution | None = None
) -> torch.Tensor:
    """Party-side: <mask, s_i> + flooding noise. ct: (..., n+1) -> (...,)."""
    partial = (ct[..., :-1] * share.share).sum(dim=-1)
    if flood is not None:
        partial = partial + rng.noise(flood, tuple(partial.shape)).to(partial.device)
    return partial


def combine_partials(ct: torch.Tensor, partials: list[torch.Tensor], delta: int, modulus: int) -> torch.Tensor:
    """Combiner-side: b - sum partials, then decode."""
    acc = ct[..., -1]
    for p in partials:
        acc = acc - p
    return decode(acc, delta, modulus)
