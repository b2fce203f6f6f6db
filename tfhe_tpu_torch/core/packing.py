"""Packing keyswitch: a list of LWE ciphertexts -> one GLWE ciphertext
(counterpart of tfhe_tpu/core/packing.py). LWE ciphertext t lands on
coefficient t of the output polynomial:

    out = (0, sum_t b_t X^t) - sum_{i,l} D_{i,l}(X) * KSK[i,l]

where D_{i,l}(X) = sum_t digit_{t,i,l} X^t gathers the t-th ciphertext's
i-th mask digit on coefficient t, and KSK[i,l] = GLWE(s_in[i] q/B^(l+1)).
The digit polynomials go through the forward transform in one launch (K1
on the card), the products are Shoup multiplies against the key summed
unreduced over (i, l), and one inverse (K2) brings the sum back.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tfhe_tpu_torch.core.glwe import encrypt_glwe
from tfhe_tpu_torch.core.keys import GlweSecretKey, LweSecretKey
from tfhe_tpu_torch.params import GadgetParams, NoiseDistribution
from tfhe_tpu_torch.rng import FheRng
from tfhe_tpu_torch.torus import mod_switch, signed_decompose

MAC_CHUNK = 128  # input coefficients per step of the transform-domain MAC


@dataclasses.dataclass
class PackingKeyswitchKey:
    """ksk_ntt: (n_in, level, k_out+1, P, 2, N) int32 Shoup pairs of the
    GLWE encryptions of s_in[i] * q/B^(l+1), modulus-switched to
    64 - shift bits before the transform (folded layout)."""

    ksk_ntt: torch.Tensor
    gadget: GadgetParams
    shift: int = 0

    @property
    def n_in(self) -> int:
        return self.ksk_ntt.shape[0]


def gen_packing_keyswitch_key(
    sk_in: LweSecretKey,
    sk_out: GlweSecretKey,
    gadget: GadgetParams,
    rng: FheRng,
    noise: NoiseDistribution,
    engine,
) -> PackingKeyswitchKey:
    b, l = gadget.base_log, gadget.level
    n_poly = sk_out.n_poly
    dev = sk_in.key.device
    shifts = torch.tensor([64 - (i + 1) * b for i in range(l)], device=dev)
    pts = torch.zeros((sk_in.n, l, n_poly), dtype=torch.int64, device=dev)
    pts[..., 0] = sk_in.key[:, None] << shifts[None, :]
    ksk = encrypt_glwe(sk_out, pts, rng, noise, engine)  # (n_in, l, k+1, N)
    # packing_keyswitch sums n_in * level digit x key products before its
    # one inverse transform: ceil(log2(n_in * level)) bits of headroom on
    # top of one product's bound, so the key is stored modulus-switched
    headroom = math.ceil(math.log2(sk_in.n * l))
    msb = min(55, engine.max_product_bits - (b - 1) - headroom)
    if msb <= 0:
        raise ValueError("packing-KS parameters exceed the CRT range")
    f = engine.forward_u64(mod_switch(ksk, msb))
    return PackingKeyswitchKey(ksk_ntt=engine.make_shoup(f), gadget=gadget, shift=64 - msb)


def packing_keyswitch(lwe_cts: torch.Tensor, pksk: PackingKeyswitchKey, engine) -> torch.Tensor:
    """lwe_cts (..., T, n_in+1) with T <= N -> GLWE (..., k_out+1, N);
    unused coefficients hold zeros (plus keyswitch noise)."""
    t = lwe_cts.shape[-2]
    k1 = pksk.ksk_ntt.shape[2]
    n_poly = pksk.ksk_ntt.shape[-1]
    if t > n_poly:
        raise ValueError(f"{t} LWE ciphertexts do not fit one polynomial of size {n_poly}")
    digits = signed_decompose(lwe_cts[..., :-1], pksk.gadget)  # (..., T, n_in, level)
    digits = digits.movedim(-3, -1)  # (..., n_in, level, T)
    digit_polys = torch.nn.functional.pad(digits, (0, n_poly - t))
    fd = engine.forward_small(digit_polys)  # (..., n_in, level, P, N)
    # Shoup products against the key over chunks of the input coefficients
    # (the full outer product is GBs at n_in = 2048), summed unreduced
    s = None
    for lo in range(0, pksk.n_in, MAC_CHUNK):
        hi = min(lo + MAC_CHUNK, pksk.n_in)
        prod = engine.pointwise_shoup(fd[..., lo:hi, :, None, :, :], pksk.ksk_ntt[lo:hi])
        part = prod.to(torch.int64).sum(dim=(-5, -4))  # (..., k+1, P, N)
        s = part if s is None else s + part
    acc = engine.backward(engine.reduce_u64_domain(s), shift=pksk.shift)  # (..., k+1, N)
    out = -acc
    out[..., k1 - 1, :t] += lwe_cts[..., -1]
    return out
