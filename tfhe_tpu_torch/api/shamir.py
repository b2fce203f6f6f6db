"""Shamir t-of-n threshold decryption with signed, verifiable partials.

Replaces round 1's additive n-of-n sharing (api/threshold.py,
which remains the batched tensor fast path) with the reference's actual
trust model: n KMS parties, any t of which suffice, with per-party
signatures on decryption shares (reference:
sdk/relayer/src/relayer/userDecrypt.ts:209-246 -- the TKMS client
verifies and recombines EIP-712-signed shares from a threshold quorum;
proto/decryption-oracle/oracle.proto:8-13 responses carry oracle
signatures; local-dev/docker-compose.yml runs `-parties 5`).

Protocol (host-side big-int math -- this is control-plane work; the
LWE mask/body tensors come off the card):

- The secret key s in {0,1}^n is Shamir-shared coefficient-wise over
  GF(P), P = 2^127 - 1: f_j random of degree t-1 with f_j(0) = s_j;
  party i holds s_i[j] = f_j(i+1).
- Partial decryption of mask `a`: d_i = <a, s_i> + e_i mod P with
  centered flooding noise |e_i| < 2^flood_bits (smudges the exact LWE
  noise; the standard threshold-FHE smudging argument). The party signs
  keccak(context || d_i) with its secp256k1 key.
- Recombination over any t valid shares: Lagrange at 0. Because
  flooding makes partials non-integral under rational Lagrange
  coefficients, we clear denominators (Shoup's trick): with
  lambda_i = L_i / D (D = lcm of the subset's denominators),
  D * sum(lambda_i d_i) = D*<a,s> + sum(L_i e_i) is an INTEGER smaller
  than P, recovered exactly from its mod-P residue, then divided by D.
  The residual flood noise sum|lambda_i| e_i rides inside the decode
  margin exactly like LWE noise.
- Fault tolerance: shares with bad signatures are rejected; any t of
  the remaining parties recombine; fewer than t raises.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from math import lcm

import numpy as np

from tfhe_tpu_torch.api import secp256k1 as ec
from tfhe_tpu_torch.utils.keccak import keccak256

P127 = (1 << 127) - 1  # Mersenne prime; > 2^74 max integer phase + floods


@dataclasses.dataclass
class ShamirShare:
    """One party's key share + signing key."""

    party: int  # evaluation point is party + 1
    n_parties: int
    threshold: int
    share: list  # (n,) ints mod P127
    sign_priv: int
    # Secret per-party PRF key for smudging noise. The flooding noise
    # e_i MUST be unpredictable to observers: if e_i were derived from
    # public values (nonce, party index), anyone could recompute it and
    # recover the exact inner product <a, s_i> from each signed partial,
    # linearly extracting key shares across requests. flood_key is dealt
    # with the share itself and never leaves the party.
    flood_key: bytes = b""

    @property
    def x(self) -> int:
        return self.party + 1

    @property
    def address(self) -> str:
        return ec.address(self.sign_priv)


@dataclasses.dataclass
class SignedPartial:
    party: int
    x: int
    value: int  # d_i mod P127
    signature: bytes  # 65-byte secp256k1 over keccak(context || value)


def share_secret_key(
    key_bits, n_parties: int, threshold: int, seed: bytes
) -> list[ShamirShare]:
    """Deal Shamir shares of a binary LWE secret key.

    key_bits: (n,) array-like of {0,1}. Deterministic from `seed` so the
    KMS parties of a test fixture are reproducible.
    """
    assert 1 <= threshold <= n_parties
    bits = [int(b) & 1 for b in np.asarray(key_bits).tolist()]
    rng = np.random.default_rng(
        int.from_bytes(keccak256(b"shamir-deal" + seed), "big") % (1 << 63)
    )

    def rand_p():
        return int.from_bytes(rng.bytes(16), "big") % P127

    shares = [[] for _ in range(n_parties)]
    for s_j in bits:
        coeffs = [s_j] + [rand_p() for _ in range(threshold - 1)]
        for i in range(n_parties):
            x = i + 1
            acc, xp = 0, 1
            for c in coeffs:
                acc = (acc + c * xp) % P127
                xp = xp * x % P127
            shares[i].append(acc)
    return [
        ShamirShare(
            party=i,
            n_parties=n_parties,
            threshold=threshold,
            share=shares[i],
            sign_priv=ec.keygen(b"kms-party" + seed + bytes([i])),
            # Secret, like the share: derived from the dealer seed (which
            # already determines the key shares), never from public data.
            flood_key=keccak256(b"flood-key" + seed + bytes([i])),
        )
        for i in range(n_parties)
    ]


def _context_digest(mask_digest: bytes, party: int, value: int) -> bytes:
    return keccak256(
        b"KMS-partial" + mask_digest + bytes([party]) + value.to_bytes(16, "big")
    )


def partial_decrypt(
    ct, share: ShamirShare, flood_bits: int = 40, nonce: bytes = b""
) -> SignedPartial:
    """Party-side: d_i = <mask, s_i> + e_i mod P, signed.

    ct: (n+1,) u64 LWE ciphertext (mask || body). flood_bits sets the
    centered smudging noise magnitude; it must stay below the decode
    margin after the <= 2^6-ish Lagrange amplification (callers pick it
    per parameter set)."""
    a = np.asarray(ct[..., :-1], dtype=np.uint64).tolist()
    acc = 0
    for aj, sj in zip(a, share.share):
        acc += int(aj) * sj
    # PRF(secret flood_key, nonce || ct-digest): unpredictable to anyone
    # who doesn't hold the party's key material. Falls back to fresh OS
    # randomness if a share was constructed without a flood_key.
    ct_digest = keccak256(np.asarray(ct, dtype=np.uint64).tobytes())
    if share.flood_key:
        stream = keccak256(b"flood" + share.flood_key + nonce + ct_digest)
    else:
        import os

        stream = os.urandom(32)
    e = int.from_bytes(stream[:16], "big") % (1 << (flood_bits + 1))
    e -= 1 << flood_bits  # centered
    d = (acc + e) % P127
    mask_digest = keccak256(np.asarray(ct, dtype=np.uint64).tobytes() + nonce)
    sig = ec.sign(share.sign_priv, _context_digest(mask_digest, share.party, d))
    return SignedPartial(party=share.party, x=share.x, value=d, signature=sig)


class ThresholdError(ValueError):
    pass


def verify_partial(
    partial: SignedPartial, ct, party_address: str, nonce: bytes = b""
) -> bool:
    mask_digest = keccak256(np.asarray(ct, dtype=np.uint64).tobytes() + nonce)
    digest = _context_digest(mask_digest, partial.party, partial.value)
    try:
        return ec.recover_address(digest, partial.signature) == party_address.lower()
    except ValueError:
        return False


def combine(
    ct,
    partials: list[SignedPartial],
    party_addresses: list[str],
    threshold: int,
    delta: int,
    modulus: int,
    nonce: bytes = b"",
):
    """Client-side recombination (the TKMS
    process_user_decryption_resp_from_js role, userDecrypt.ts:238-246):
    verify signatures, drop bad shares, Lagrange-combine any `threshold`
    valid ones, decode the plaintext. Raises ThresholdError if fewer
    than `threshold` partials survive verification."""
    valid = [
        p
        for p in partials
        if p.party < len(party_addresses)
        and verify_partial(p, ct, party_addresses[p.party], nonce)
    ]
    # distinct parties only
    seen, uniq = set(), []
    for p in valid:
        if p.x not in seen:
            seen.add(p.x)
            uniq.append(p)
    if len(uniq) < threshold:
        raise ThresholdError(
            f"{len(uniq)} valid shares below threshold {threshold}"
        )
    subset = uniq[:threshold]
    xs = [p.x for p in subset]
    lams = []
    for i, xi in enumerate(xs):
        lam = Fraction(1)
        for j, xj in enumerate(xs):
            if i != j:
                lam *= Fraction(xj, xj - xi)
        lams.append(lam)
    d_common = lcm(*(l.denominator for l in lams))
    ls = [int(l * d_common) for l in lams]  # integer Lagrange numerators
    v = sum(l * p.value for l, p in zip(ls, subset)) % P127
    # D*T = D*phase + sum L_i e_i is a small integer; lift centered
    w = v if v <= P127 // 2 else v - P127
    # rounded division back to the phase (residual flood < decode margin)
    phase = (w + d_common // 2) // d_common
    body = int(np.asarray(ct[..., -1], dtype=np.uint64))
    import torch

    from tfhe_tpu_torch import _u64
    from tfhe_tpu_torch.torus import decode

    raw = torch.tensor(_u64.const(body - phase), dtype=torch.int64)
    return int(decode(raw, delta, modulus))
