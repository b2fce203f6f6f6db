"""GLWE encryption/decryption over q = 2^64 (counterpart of
tfhe_tpu/core/glwe.py). A GLWE ciphertext is an int64 tensor (..., k+1, N):
k mask polynomials followed by the body."""

from __future__ import annotations

import torch

from tfhe_tpu_torch.core.keys import GlweSecretKey, glwe_key_ntt
from tfhe_tpu_torch.params import NoiseDistribution
from tfhe_tpu_torch.rng import FheRng


def mask_times_key(mask: torch.Tensor, sk_ntt: torch.Tensor, engine) -> torch.Tensor:
    """sum_j mask_j * s_j (negacyclic, mod 2^64). mask (..., k, N);
    sk_ntt (k, P, 2, N) from keys.glwe_key_ntt. Returns (..., N)."""
    k = mask.shape[-2]
    fm = engine.forward_u64(mask)  # (..., k, P, N)
    acc = None
    for j in range(k):
        term = engine.pointwise_shoup(fm[..., j, :, :], sk_ntt[j])
        acc = term if acc is None else engine.add_domain(acc, term)
    return engine.backward(acc)


def encrypt_glwe(
    sk: GlweSecretKey,
    pt: torch.Tensor,
    rng: FheRng,
    noise: NoiseDistribution,
    engine,
    sk_ntt: torch.Tensor | None = None,
) -> torch.Tensor:
    """Encrypt plaintext polynomial(s) pt (..., N) -> (..., k+1, N)."""
    if sk_ntt is None:
        sk_ntt = glwe_key_ntt(sk, engine)
    batch = tuple(pt.shape[:-1])
    n = pt.shape[-1]
    mask = rng.uniform_torus(batch + (sk.k, n)).to(pt.device)
    e = rng.noise(noise, batch + (n,)).to(pt.device)
    body = pt + e + mask_times_key(mask, sk_ntt, engine)
    return torch.cat([mask, body[..., None, :]], dim=-2)


def decrypt_glwe(sk: GlweSecretKey, ct: torch.Tensor, engine, sk_ntt=None) -> torch.Tensor:
    """Phase: body - sum mask_j * s_j. Returns (..., N)."""
    if sk_ntt is None:
        sk_ntt = glwe_key_ntt(sk, engine)
    return ct[..., -1, :] - mask_times_key(ct[..., :-1, :], sk_ntt, engine)


def trivial_glwe(pt: torch.Tensor, k: int) -> torch.Tensor:
    """Noiseless, keyless encryption (mask = 0): (..., N) -> (..., k+1, N)."""
    mask = torch.zeros(tuple(pt.shape[:-1]) + (k, pt.shape[-1]), dtype=torch.int64, device=pt.device)
    return torch.cat([mask, pt.to(torch.int64)[..., None, :]], dim=-2)
