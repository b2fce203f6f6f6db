"""Plain GLWE encrypted x clear matrix multiplication over q = 2^64 in
torch: the keys worked out again from the seed, the encryption of the input
rows, the product, the packing keyswitch, the switch to the output modulus
and decryption. The yardstick for the matmul cells' `correct`.

The algorithm (concrete-ml-extensions' encrypted x clear matmul):

  * an input row v of length C is packed into ceil(C/N) GLWE polynomials
    at delta = 2^(64 - bits_reserved_for_computation) and encrypted under
    the input key;
  * the LWE of the dot product v . w_o is sum_c w[c, o] times the LWE
    extracted at coefficient c of the row's GLWE; its mask is the product of
    the negacyclic matrix of each mask polynomial with the weights, its body
    the body polynomial's dot with the weights;
  * the O LWEs of a row are packed into ceil(O/N) GLWEs under the post key
    by the packing keyswitch: output t lands on coefficient t,
    out = (0, sum_t b_t X^t) - sum_t X^t sum_{i,l} digit_{t,i,l} KSK[i,l],
    with KSK[i,l] = GLWE_post(s_in[i] q / B^(l+1)), at all 64 bits;
  * each coefficient is switched to 2^ct_modulus_out_bits with rounding.

Every product is exact: the 64-bit operand is split into limbs narrow
enough that a float64 matrix product of a limb with the small operand
(weights or gadget digits) sums below 2^53, and the limbs are recombined
with wrapping shifts. `dtype=torch.float32` computes the same products in
float32, the lower-precision control.

Nothing here imports the measured program; key generation repeats the
draws of its seeded generator in its order: input key, post key, then the
packing keyswitch key's masks and noise.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark.reference import tfhe as rt
from benchmark.reference.rng import KeyRng


@dataclasses.dataclass(frozen=True)
class Params:
    """The numbers of one matmul parameter set, as a configuration file
    states them."""

    glwe_dimension: int
    polynomial_size: int
    glwe_noise_log2: int
    bits_reserved_for_computation: int
    packing_ks_base_log: int
    packing_ks_level: int
    packing_ks_noise_log2: int
    ct_modulus_out_bits: int

    @property
    def delta(self) -> int:
        return 1 << (64 - self.bits_reserved_for_computation)

    @classmethod
    def from_config(cls, cfg: dict) -> "Params":
        return cls(**{f.name: cfg[f.name] for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class Keys:
    input_key: torch.Tensor  # (k, N) bits
    post_key: torch.Tensor  # (k, N) bits
    pksk: torch.Tensor  # (kN, level, k+1, N): GLWE rows under the post key


def input_key(p: Params, seed: int, device) -> torch.Tensor:
    """The input GLWE key, the first draw."""
    return KeyRng(seed, device).binary((p.glwe_dimension, p.polynomial_size))


def keygen(p: Params, seed: int, device) -> Keys:
    rng = KeyRng(seed, device)
    k, n = p.glwe_dimension, p.polynomial_size
    s_in = rng.binary((k, n))
    s_post = rng.binary((k, n))
    level, base_log = p.packing_ks_level, p.packing_ks_base_log
    shifts = torch.tensor([64 - (i + 1) * base_log for i in range(level)], device=device)
    pts = torch.zeros((k * n, level, n), dtype=torch.int64, device=device)
    pts[..., 0] = s_in.reshape(-1)[:, None] << shifts[None, :]
    mask = rng.uniform_u64((k * n, level, k, n))
    e = rng.tuniform(p.packing_ks_noise_log2, (k * n, level, n))
    body = pts + e + rt.glwe_mask_times_key(mask, s_post)
    return Keys(input_key=s_in, post_key=s_post, pksk=torch.cat([mask, body[:, :, None]], dim=2))


def encrypt_rows(p: Params, key: torch.Tensor, values: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """values (R, C) unsigned ints below 2^bits -> GLWEs (R, ceil(C/N), k+1,
    N) of values * delta, masks and noise drawn from the torch generator
    `gen` (noise uniform on [-2^b, 2^b] for the set's TUniform bound 2^b)."""
    r, c = values.shape
    k, n = p.glwe_dimension, p.polynomial_size
    chunks = -(-c // n)
    pts = torch.nn.functional.pad(values.to(torch.int64), (0, chunks * n - c)).reshape(r, chunks, n) * p.delta
    lo, hi = -(2**63), 2**63 - 1
    mask = torch.randint(lo, hi, (r, chunks, k, n), generator=gen, device=values.device, dtype=torch.int64)
    bound = 1 << p.glwe_noise_log2
    e = torch.randint(-bound, bound + 1, (r, chunks, n), generator=gen, device=values.device, dtype=torch.int64)
    body = pts + e + rt.glwe_mask_times_key(mask, key)
    return torch.cat([mask, body[..., None, :]], dim=-2)


# -- exact products -------------------------------------------------------------


def limb_bits(small_max: int, terms: int) -> int:
    """The limb width for products of u64 values with `terms` small factors
    of magnitude at most `small_max` summed in float64: every partial sum
    stays below 2^53, and the 64 bits split into equal limbs."""
    widest = 53 - math.ceil(math.log2(max(small_max, 1) * terms))
    return -(-64 // -(-64 // widest))


def _limbs(x: torch.Tensor, bits: int, dtype) -> list[torch.Tensor]:
    return [(rt.srl(x, bits * i) & ((1 << bits) - 1)).to(dtype) for i in range(-(-64 // bits))]


def _join(parts: list[torch.Tensor], bits: int) -> torch.Tensor:
    out = torch.zeros(parts[0].shape, dtype=torch.int64, device=parts[0].device)
    for i, part in enumerate(parts):
        out = out + (torch.round(part).to(torch.int64) << (bits * i))
    return out


def extracted_products(p: Params, glwes: torch.Tensor, weights: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """glwes (B, chunks, k+1, N), weights (C, O) small signed ints -> the
    LWEs of the dot products (B, O, kN+1) under the input key.

    The LWE extracted at coefficient j of a GLWE has, for key polynomial m,
    the mask A_m[j - i] (i <= j) or -A_m[N + j - i] (i > j): row j of the
    transposed negacyclic matrix of A_m. So the dot product's mask is that
    matrix times the weights, and its body the body polynomial's dot with
    them, summed over the chunks."""
    b, chunks, k1, n = glwes.shape
    c, o = weights.shape
    w = torch.nn.functional.pad(weights.to(torch.int64), (0, 0, 0, chunks * n - c)).reshape(chunks, n, o).to(dtype)
    bits = limb_bits(int(weights.abs().max()), n)
    mask = torch.zeros((b, o, k1 - 1, n), dtype=torch.int64, device=glwes.device)
    body = torch.zeros((b, o), dtype=torch.int64, device=glwes.device)
    for ch in range(chunks):
        for m in range(k1 - 1):
            nm = rt.negacyclic_matrix(glwes[:, ch, m])  # (B, N, N)
            mask[:, :, m] += _join([limb @ w[ch] for limb in _limbs(nm, bits, dtype)], bits).transpose(1, 2)
            del nm
        body += _join([limb @ w[ch] for limb in _limbs(glwes[:, ch, k1 - 1], bits, dtype)], bits)
    return torch.cat([mask.reshape(b, o, -1), body[..., None]], dim=-1)


def packing_keyswitch(p: Params, pksk: torch.Tensor, lwes: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """lwes (B, O, kN+1) under the input key -> GLWEs (B, ceil(O/N), k+1, N)
    under the post key, output t on coefficient t mod N of chunk t // N.

    G_t = sum_{i,l} digit_{t,i,l} KSK[i,l] is one exact matrix product of
    the digits with the key's rows; X^t G_t is a negacyclic rotation."""
    b, o, _ = lwes.shape
    n = p.polynomial_size
    k1 = pksk.shape[2]
    rows = pksk.reshape(-1, k1 * n)  # (kN * level, (k+1) N), row i * level + l
    digits = rt.decompose(lwes[..., :-1], p.packing_ks_base_log, p.packing_ks_level)  # (B, O, kN, level)
    small = digits.reshape(b * o, -1).to(dtype)
    bits = limb_bits(1 << (p.packing_ks_base_log - 1), rows.shape[0])
    g = _join([small @ limb for limb in _limbs(rows, bits, dtype)], bits).reshape(b, o, k1, n)
    del small
    out = []
    for lo in range(0, o, n):
        t = min(n, o - lo)
        part = g[:, lo:lo + t].reshape(b * t, k1, n)
        shift = torch.arange(t, device=g.device).repeat(b)
        acc = rt.rotate(part, shift).reshape(b, t, k1, n).sum(dim=1)
        chunk = -acc
        chunk[:, k1 - 1, :t] += lwes[:, lo:lo + t, -1]
        out.append(chunk)
    return torch.stack(out, dim=1)


ROW_BLOCK = 4  # rows a step of `matmul`, so that it fits beside what the card holds


def matmul(p: Params, keys: Keys, glwes: torch.Tensor, weights: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """Encrypted rows (B, chunks, k+1, N) x clear weights (C, O) -> the
    stored result (B, ceil(O/N), k+1, N): values below 2^ct_modulus_out_bits.
    In blocks of ROW_BLOCK rows."""
    out = []
    for lo in range(0, glwes.shape[0], ROW_BLOCK):
        lwes = extracted_products(p, glwes[lo:lo + ROW_BLOCK], weights, dtype)
        packed = packing_keyswitch(p, keys.pksk, lwes, dtype)
        out.append(rt.mod_switch(packed, p.ct_modulus_out_bits))
        del lwes, packed
    return torch.cat(out)


def output_phase(p: Params, post_key: torch.Tensor, stored: torch.Tensor, n_out: int) -> torch.Tensor:
    """Stored results (..., ceil(O/N), k+1, N) of values below
    2^ct_modulus_out_bits -> the phase of each of the O outputs (..., O),
    lifted back to q = 2^64. The mask product is exact in float64 at the
    output modulus (out_bits + log2(kN) < 53), then shifted up."""
    bits = p.ct_modulus_out_bits
    k = post_key.shape[0]
    v = stored.to(torch.int64)
    acc = v[..., k, :].clone()
    for j in range(k):
        m = rt.negacyclic_matrix(post_key[j].to(torch.float64))
        acc -= (v[..., j, :].to(torch.float64) @ m).to(torch.int64)
    ph = ((acc & ((1 << bits) - 1)) << (64 - bits))
    return ph.reshape(*ph.shape[:-2], -1)[..., :n_out]
