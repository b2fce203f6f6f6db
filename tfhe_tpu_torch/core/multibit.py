"""Multi-bit programmable bootstrapping: g secret bits per blind-rotation
step (counterpart of tfhe_tpu/core/multibit.py).

The key stores, per group j of g secret bits, GGSW encryptions of the 2^g
pattern indicators [s_grp == v] (exactly one is 1), since

    X^{sum_i a_i s_i} = sum_{v in {0,1}^g} [s_grp == v] * X^{<a, v>},

and each of the n/g steps aggregates sum_v NTT(X^{<a, v>}) . BSK_{j,v}
before ONE external product replaces the accumulator:
acc <- EP(GGSW_agg, acc). The aggregation sums 2^g GGSW noise terms, and
the key is stored g bits below the CRT headroom so the sum cannot wrap.

For gadget level 1, k = 1 and base_log <= 31 (the default parameter sets)
the rotation runs every group step in one call of
ops/multibit_cuda.group_steps: kernel K4 on the card, its plain version on
the CPU. Other shapes take the loop form of the JAX scan path.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tfhe_tpu_torch.core.ggsw import decompose_forward, encrypt_ggsw_bits, finalize_residues, ggsw_to_ntt
from tfhe_tpu_torch.core.keys import GlweSecretKey, LweSecretKey
from tfhe_tpu_torch.core.lwe import keyswitch, sample_extract
from tfhe_tpu_torch.ops.multibit_cuda import group_steps
from tfhe_tpu_torch.params import GadgetParams, NoiseDistribution
from tfhe_tpu_torch.rng import FheRng
from tfhe_tpu_torch.torus import mod_switch, negacyclic_monomial_rotate


@dataclasses.dataclass
class MultiBitBootstrapKey:
    """bsk_ntt (n_groups, 2^g, D, k+1, P, 2, N) int32 Shoup pairs:
    GGSW(indicator) per (group, bit pattern); rot_table (2N, P, 2, N)
    int32, the Shoup rows of NTT(X^e) the group steps read."""

    bsk_ntt: torch.Tensor
    gadget: GadgetParams
    shift: int
    group_size: int
    rot_table: torch.Tensor | None = None

    @property
    def n_groups(self) -> int:
        return self.bsk_ntt.shape[0]

    @property
    def lwe_dim(self) -> int:
        return self.n_groups * self.group_size

    @property
    def poly_size(self) -> int:
        return self.bsk_ntt.shape[-1]


def multibit_msb(gadget: GadgetParams, group_size: int, engine) -> int:
    """Key-storage bits: the full CRT headroom minus the digit bits and
    minus g aggregation bits. The reconstructed integer is a sum of 2^g
    monomial-rotated convolutions, so a wider key lets rare coefficient
    sums wrap the CRT range (sporadic 2^60 phase errors, no crash)."""
    msb = min(55, engine.max_product_bits - (gadget.base_log - 1) - group_size)
    if gadget.base_log - 1 + msb + group_size > engine.max_product_bits:
        raise ValueError("gadget digits x key values exceed the CRT range")
    return msb


def gen_multibit_bootstrap_key(
    lwe_sk: LweSecretKey,
    glwe_sk: GlweSecretKey,
    gadget: GadgetParams,
    group_size: int,
    rng: FheRng,
    noise: NoiseDistribution,
    engine,
) -> MultiBitBootstrapKey:
    g = group_size
    n = lwe_sk.n
    if n % g:
        raise ValueError(f"lwe dimension {n} not divisible by group size {g}")
    n_groups = n // g
    v_count = 1 << g
    dev = lwe_sk.key.device
    grp = lwe_sk.key.reshape(n_groups, g)
    patterns = torch.tensor([[(v >> i) & 1 for i in range(g)] for v in range(v_count)], device=dev)
    ind = (grp[:, None, :] == patterns[None]).all(dim=-1).to(torch.int64)  # (G, V)
    ggsw = encrypt_ggsw_bits(glwe_sk, ind.reshape(-1), gadget, rng, noise, engine)  # (G*V, D, k+1, N)
    bsk_ntt, shift = ggsw_to_ntt(ggsw, engine, msb_bits=multibit_msb(gadget, g, engine))
    bsk_ntt = bsk_ntt.reshape(n_groups, v_count, *bsk_ntt.shape[1:])
    return MultiBitBootstrapKey(
        bsk_ntt=bsk_ntt, gadget=gadget, shift=shift, group_size=g, rot_table=monomial_x_table(engine)
    )


def monomial_x_table(engine) -> torch.Tensor:
    """(2N, P, 2, N) int32: Shoup pairs of NTT(X^e) for e in [0, 2N)
    (X^{N+j} = -X^j). The multi-bit analog of
    ops/blind_rotate_cuda.monomial_ntt_table, without the -1 term."""
    n = engine.n
    polys = np.zeros((2 * n, n), dtype=np.int64)
    e = np.arange(n)
    polys[e, e] = 1
    polys[n + e, e] = -1
    f = engine.forward_small(torch.from_numpy(polys).to(engine.device))
    return engine.make_shoup(f)


def group_exponents(a_t: torch.Tensor, group_size: int, two_n: int) -> torch.Tensor:
    """Mod-switched mask exponents (..., n) -> per-group subset sums
    (n_groups, 2^g, ...): e[j, v] = sum_{i in v} a[g*j + i] mod 2N."""
    g = group_size
    v_count = 1 << g
    n = a_t.shape[-1]
    grp = a_t.to(torch.int64).movedim(-1, 0).reshape(n // g, g, *a_t.shape[:-1])
    e = torch.zeros((n // g, v_count) + tuple(a_t.shape[:-1]), dtype=torch.int64, device=a_t.device)
    for i in range(g):
        mask = torch.tensor([(v >> i) & 1 for v in range(v_count)], device=a_t.device)
        e = e + mask.reshape((1, v_count) + (1,) * (a_t.dim() - 1)) * grp[:, None, i]
    return e % two_n


def uses_fused_group_steps(bsk: MultiBitBootstrapKey, k1: int) -> bool:
    return bsk.gadget.level == 1 and bsk.gadget.base_log <= 31 and k1 == 2


def multibit_blind_rotate(lut, lwe_ct, bsk: MultiBitBootstrapKey, engine, steps=group_steps) -> torch.Tensor:
    """Rotate the LUT accumulator by the mod-switched phase of lwe_ct over
    n/g aggregated-GGSW steps. lut (k+1, N) or (..., k+1, N); lwe_ct
    (..., n+1) -> (..., k+1, N). `steps` is the fused group-step function
    (group_steps_plain to force the plain version on the card)."""
    n_poly = bsk.poly_size
    two_n = 2 * n_poly
    ms = mod_switch(lwe_ct, int(math.log2(two_n)))
    a_t = ms[..., :-1]
    b_t = ms[..., -1]
    acc = negacyclic_monomial_rotate(lut, (two_n - b_t)[..., None])
    acc = acc.expand(*b_t.shape, lut.shape[-2], n_poly)
    table = bsk.rot_table if bsk.rot_table is not None else monomial_x_table(engine)
    if uses_fused_group_steps(bsk, lut.shape[-2]):
        batch = acc.shape[:-2]
        flat = acc.reshape(-1, 2, n_poly).contiguous()
        a = a_t.reshape(flat.shape[0], -1).t().to(torch.int32)  # (n, B)
        out = steps(flat, a, bsk.bsk_ntt, table, engine, bsk.gadget.base_log, bsk.shift, bsk.group_size)
        return out.reshape(*batch, 2, n_poly)
    # loop form (the JAX lax.scan step): aggregate, then one external product
    e_all = group_exponents(a_t, bsk.group_size, two_n)  # (G, V, ...)
    batch_dims = a_t.dim() - 1
    for j in range(bsk.n_groups):
        mono = table[e_all[j]]  # (V, ..., P, 2, N)
        bv = bsk.bsk_ntt[j][..., 0, :]  # (V, D, k+1, P, N)
        fa = bv.reshape(bv.shape[0], *([1] * batch_dims), *bv.shape[1:])
        prod = engine.pointwise_shoup(fa, mono[..., None, None, :, :, :])  # (V, ..., D, k+1, P, N)
        # residues in [0, 2p) summed exactly in int64
        agg = engine.reduce_u64_domain(prod.to(torch.int64).sum(dim=0), canonical=True)  # (..., D, k+1, P, N)
        fd = decompose_forward(acc, bsk.gadget, engine)  # (..., D, P, N)
        ep = engine.pointwise_mul(fd[..., :, None, :, :], agg)
        s = engine.reduce_u64_domain(ep.to(torch.int64).sum(dim=-4), canonical=True)
        acc = finalize_residues(s, engine, shift=bsk.shift)
    return acc


def multibit_programmable_bootstrap(lwe_ct, lut, bsk: MultiBitBootstrapKey, engine, steps=group_steps) -> torch.Tensor:
    """Multi-bit PBS: blind rotate (n/g steps) + sample extract."""
    return sample_extract(multibit_blind_rotate(lut, lwe_ct, bsk, engine, steps), 0)


def multibit_keyswitch_pbs(big_lwe_ct, lut, bsk: MultiBitBootstrapKey, ksk, engine, steps=group_steps) -> torch.Tensor:
    """Keyswitch down to the small key, then multi-bit PBS."""
    return multibit_programmable_bootstrap(keyswitch(big_lwe_ct, ksk), lut, bsk, engine, steps)
