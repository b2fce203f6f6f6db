"""Programmable bootstrapping: blind rotation over the CMux chain
(counterpart of tfhe_tpu/core/bootstrap.py).

  1. modulus-switch the LWE ciphertext into the Z_2N exponent domain,
  2. blind rotation: acc = X^{-b} * LUT, then for each secret bit j a
     CMux between acc and X^{a_j} * acc,
  3. sample-extract coefficient 0 under the big key.

For gadget level 1, k = 1 and base_log <= 31 (the default parameter set)
the rotation runs as the rotation-free CMux acc += (X^a - 1) * EP(acc),
all n steps in one call of ops/blind_rotate_cuda.cmux_steps: kernel K3 on
the card, its plain version on the CPU. Other shapes take a loop of
external products.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tfhe_tpu_torch.core.ggsw import encrypt_ggsw_bits, external_product, ggsw_to_ntt
from tfhe_tpu_torch.core.keys import GlweSecretKey, LweSecretKey
from tfhe_tpu_torch.core.lwe import keyswitch, sample_extract
from tfhe_tpu_torch.ops.blind_rotate_cuda import cmux_steps, monomial_ntt_table
from tfhe_tpu_torch.params import GadgetParams, NoiseDistribution
from tfhe_tpu_torch.rng import FheRng
from tfhe_tpu_torch.torus import mod_switch, negacyclic_monomial_rotate


@dataclasses.dataclass
class BootstrapKey:
    """NTT-domain bootstrap key: bsk_ntt (n, D, k+1, P, 2, N) int32 Shoup
    pairs of the GGSWs, modulus-switched to 64 - shift bits before the
    transform; rot_table (2N, P, 2, N) int32, the Shoup rows of
    NTT(X^e - 1) the fused CMux reads."""

    bsk_ntt: torch.Tensor
    gadget: GadgetParams
    shift: int
    rot_table: torch.Tensor | None = None

    @property
    def lwe_dim(self) -> int:
        return self.bsk_ntt.shape[0]

    @property
    def poly_size(self) -> int:
        return self.bsk_ntt.shape[-1]


def gen_bootstrap_key(
    lwe_sk: LweSecretKey,
    glwe_sk: GlweSecretKey,
    gadget: GadgetParams,
    rng: FheRng,
    noise: NoiseDistribution,
    engine,
) -> BootstrapKey:
    """GGSW-encrypt each bit of the small LWE secret under the GLWE key."""
    ggsw = encrypt_ggsw_bits(glwe_sk, lwe_sk.key, gadget, rng, noise, engine)
    rot_table = monomial_ntt_table(engine)
    # full CRT headroom minus 1 bit for the (X^a - 1) NTT-domain multiply
    msb = min(55, engine.max_product_bits - (gadget.base_log - 1) - 1)
    if gadget.base_log - 1 + msb + 1 > engine.max_product_bits:
        raise ValueError("gadget digits x key values exceed the CRT range")
    bsk_ntt, shift = ggsw_to_ntt(ggsw, engine, msb_bits=msb)
    return BootstrapKey(bsk_ntt=bsk_ntt, gadget=gadget, shift=shift, rot_table=rot_table)


def uses_fused_cmux(bsk: BootstrapKey, k1: int) -> bool:
    return bsk.gadget.level == 1 and bsk.gadget.base_log <= 31 and k1 == 2


def blind_rotate(lut: torch.Tensor, lwe_ct: torch.Tensor, bsk: BootstrapKey, engine, cmux=cmux_steps) -> torch.Tensor:
    """Rotate the LUT accumulator by the mod-switched phase of lwe_ct.
    lut (k+1, N) or (..., k+1, N); lwe_ct (..., n+1) -> (..., k+1, N).
    `cmux` is the fused step function (cmux_steps_plain to force the
    plain version on the card)."""
    n_poly = bsk.poly_size
    two_n = 2 * n_poly
    ms = mod_switch(lwe_ct, int(math.log2(two_n)))
    a_t = ms[..., :-1]
    b_t = ms[..., -1]
    acc = negacyclic_monomial_rotate(lut, (two_n - b_t)[..., None])
    acc = acc.expand(*b_t.shape, lut.shape[-2], n_poly)
    a_steps = a_t.movedim(-1, 0)  # (n, ...)
    if uses_fused_cmux(bsk, lut.shape[-2]):
        return _blind_rotate_fused(acc, a_steps, bsk, engine, cmux)
    for j in range(bsk.lwe_dim):
        rot = negacyclic_monomial_rotate(acc, a_steps[j][..., None])
        acc = acc + external_product(bsk.bsk_ntt[j], rot - acc, bsk.gadget, engine, shift=bsk.shift)
    return acc


def _blind_rotate_fused(acc, a_steps, bsk: BootstrapKey, engine, cmux=cmux_steps) -> torch.Tensor:
    """All n rotation-free CMux steps in one call. acc (..., 2, N) int64;
    a_steps (n, ...)."""
    rot_table = bsk.rot_table if bsk.rot_table is not None else monomial_ntt_table(engine)
    batch = acc.shape[:-2]
    n_poly = acc.shape[-1]
    flat = acc.reshape(-1, 2, n_poly).contiguous()
    e = a_steps.reshape(a_steps.shape[0], flat.shape[0]).to(torch.int32)
    out = cmux(flat, e, bsk.bsk_ntt, rot_table, engine, bsk.gadget.base_log, bsk.shift)
    return out.reshape(*batch, 2, n_poly)


def programmable_bootstrap(lwe_ct, lut, bsk: BootstrapKey, engine, cmux=cmux_steps) -> torch.Tensor:
    """Blind rotate + sample extract: (..., n+1) -> (..., kN+1)."""
    return sample_extract(blind_rotate(lut, lwe_ct, bsk, engine, cmux), 0)


def keyswitch_pbs(big_lwe_ct, lut, bsk: BootstrapKey, ksk, engine, cmux=cmux_steps) -> torch.Tensor:
    """Keyswitch down to the small key, then PBS."""
    return programmable_bootstrap(keyswitch(big_lwe_ct, ksk), lut, bsk, engine, cmux)
