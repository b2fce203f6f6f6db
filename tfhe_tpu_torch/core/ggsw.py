"""GGSW ciphertexts, external product and CMux (counterpart of
tfhe_tpu/core/ggsw.py). A GGSW of m is (k+1)*level GLWE rows; row
(j, l) adds m * q/B^(l+1) to the constant coefficient of component j.
Keys are held in NTT/Shoup form, so an external product is
decompose -> forward NTT -> pointwise MAC -> inverse NTT."""

from __future__ import annotations

import torch

from tfhe_tpu_torch.core.glwe import encrypt_glwe
from tfhe_tpu_torch.core.keys import GlweSecretKey
from tfhe_tpu_torch.params import GadgetParams, NoiseDistribution
from tfhe_tpu_torch.rng import FheRng
from tfhe_tpu_torch.torus import mod_switch, signed_decompose


def encrypt_ggsw_bits(
    sk: GlweSecretKey,
    m: torch.Tensor,
    gadget: GadgetParams,
    rng: FheRng,
    noise: NoiseDistribution,
    engine,
) -> torch.Tensor:
    """Encrypt small integers m (...,) -> GGSW (..., (k+1)*level, k+1, N)."""
    m = m.to(torch.int64)
    k1 = sk.k + 1
    level = gadget.level
    d_rows = k1 * level
    zeros = torch.zeros(tuple(m.shape) + (d_rows, sk.n_poly), dtype=torch.int64, device=m.device)
    rows = encrypt_glwe(sk, zeros, rng, noise, engine)  # (..., D, k+1, N)
    shifts = torch.tensor([64 - (l + 1) * gadget.base_log for l in range(level)], device=m.device)
    gvals = m[..., None] << shifts  # (..., level)
    j_idx = torch.arange(d_rows, device=m.device) // level
    l_idx = torch.arange(d_rows, device=m.device) % level
    onehot = (j_idx[:, None] == torch.arange(k1, device=m.device)[None, :]).to(torch.int64)
    add = gvals[..., l_idx][..., None] * onehot  # (..., D, k+1)
    rows[..., 0] += add
    return rows


def ggsw_to_ntt(ggsw: torch.Tensor, engine, msb_bits: int | None = None):
    """(..., D, k+1, N) -> (..., D, k+1, P, 2, N) int32 Shoup pairs. With
    msb_bits the key is first modulus-switched to that many bits (CRT
    headroom) and the shift 64 - msb_bits is returned beside it."""
    if msb_bits is None:
        return engine.make_shoup(engine.forward_u64(ggsw))
    f = engine.forward_u64(mod_switch(ggsw, msb_bits))
    return engine.make_shoup(f), 64 - msb_bits


def decompose_forward(glwe: torch.Tensor, gadget: GadgetParams, engine) -> torch.Tensor:
    """(..., k+1, N) -> forward-transformed digit rows (..., D, P, N)."""
    k1, n = glwe.shape[-2], glwe.shape[-1]
    digits = signed_decompose(glwe, gadget)  # (..., k+1, N, level)
    digits = digits.movedim(-1, -2).reshape(*glwe.shape[:-2], k1 * gadget.level, n)
    return engine.forward_small(digits)


def contract_residues(ggsw_ntt: torch.Tensor, fd: torch.Tensor, engine) -> torch.Tensor:
    """Transform-domain MAC over the D rows; canonical residues
    (..., k+1, P, N)."""
    prod = engine.pointwise_shoup(fd[..., :, None, :, :], ggsw_ntt)  # (..., D, k+1, P, N)
    s = prod.to(torch.int64).sum(dim=-4)
    return engine.reduce_u64_domain(s, canonical=True)


def finalize_residues(res: torch.Tensor, engine, shift: int = 0) -> torch.Tensor:
    """Inverse-transform contracted residues -> (..., k+1, N) int64."""
    return engine.backward(engine.condsub_domain(res), shift=shift)


def external_product(
    ggsw_ntt: torch.Tensor, glwe: torch.Tensor, gadget: GadgetParams, engine, shift: int = 0
) -> torch.Tensor:
    """GGSW(m) x GLWE(pt) -> GLWE(m*pt)."""
    fd = decompose_forward(glwe, gadget, engine)
    return finalize_residues(contract_residues(ggsw_ntt, fd, engine), engine, shift=shift)


def cmux(ggsw_ntt, ct_false, ct_true, gadget: GadgetParams, engine, shift: int = 0):
    """ct_true where the GGSW encrypts 1, ct_false where 0."""
    return ct_false + external_product(ggsw_ntt, ct_true - ct_false, gadget, engine, shift=shift)
