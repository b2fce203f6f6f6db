"""Plain TFHE over q = 2^64 in torch: key generation from the seed, the
keyswitch, the programmable bootstrap (classic and multi-bit), sample
extraction and decryption. The benchmark's yardstick for `correct`.

Torus values ride in int64 lanes; sums and products wrap mod 2^64. Every
polynomial product is exact: the 64-bit operand is split into four 16-bit
limbs, each limb product is one float64 matrix product against a
negacyclic (Toeplitz) matrix whose partial sums stay below 2^53, and the
limbs are recombined with wrapping shifts. `dtype=torch.float32` computes
the same products in float32, the lower-precision control.

The bootstrap follows the published algorithm at full precision: the
bootstrap key is used as generated, all 64 bits of it. For k = 1 it takes
the rotation-free CMux step acc += (X^a - 1) * EP(acc); for multi-bit
keys each group replaces acc by sum_v X^(e_v) * EP_v(acc).

Nothing here imports the measured program; key generation repeats the
draws of its seeded generator (`rng.KeyRng`) in its order: GLWE key,
small key, bootstrap key (masks, then noise), keyswitch key (masks, then
noise).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark.reference.rng import KeyRng

LIMB_BITS = 16
LIMBS = 64 // LIMB_BITS


@dataclasses.dataclass(frozen=True)
class Params:
    """The numbers of one shortint parameter set, as a configuration file
    states them."""

    lwe_dimension: int
    glwe_dimension: int
    polynomial_size: int
    lwe_noise_log2: int | None  # TUniform bound; None: no noise
    glwe_noise_log2: int | None
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int
    message_modulus: int
    carry_modulus: int
    grouping_factor: int | None = None  # multi-bit group size, None: classic

    @property
    def big_n(self) -> int:
        return self.glwe_dimension * self.polynomial_size

    @property
    def delta(self) -> int:
        return 2**64 // (2 * self.message_modulus * self.carry_modulus)

    @classmethod
    def from_config(cls, cfg: dict) -> "Params":
        return cls(**{f.name: cfg[f.name] for f in dataclasses.fields(cls) if f.name in cfg})


@dataclasses.dataclass
class Keys:
    glwe_sk: torch.Tensor  # (k, N) bits
    lwe_sk: torch.Tensor  # (n,) bits
    bsk: torch.Tensor  # (n or groups * 2^g, (k+1) * level, k+1, N): GGSW rows
    ksk: torch.Tensor  # (kN, ks_level, n+1)

    @property
    def big_sk(self) -> torch.Tensor:
        return self.glwe_sk.reshape(-1)


# -- 64-bit helpers -------------------------------------------------------------


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64."""
    return (x >> s) & ((1 << (64 - s)) - 1) if s else x


def round_msb(x: torch.Tensor, msb: int) -> torch.Tensor:
    """x rounded to its `msb` most significant bits, as an msb-bit integer."""
    shift = 64 - msb
    return srl(x + (1 << (shift - 1)), shift) if shift else x


def mod_switch(x: torch.Tensor, log2_target: int) -> torch.Tensor:
    return round_msb(x, log2_target) & ((1 << log2_target) - 1)


def decompose(x: torch.Tensor, base_log: int, level: int) -> torch.Tensor:
    """Balanced gadget digits in [-B/2, B/2) of the closest representable
    value, most significant first, on a new trailing axis."""
    base, half = 1 << base_log, 1 << (base_log - 1)
    state = round_msb(x, base_log * level)
    digits = []
    for _ in range(level):
        d = state & (base - 1)
        state = srl(state, base_log)
        carry = (d >= half).to(torch.int64)
        digits.append(d - carry * base)
        state = state + carry
    return torch.stack(digits[::-1], dim=-1)


def centered(x: torch.Tensor) -> torch.Tensor:
    """|x| of u64 torus values read as signed, in float64."""
    return x.to(torch.float64).abs()


# -- exact products -------------------------------------------------------------


def _limbs(x: torch.Tensor, dtype) -> list[torch.Tensor]:
    return [(srl(x, LIMB_BITS * i) & ((1 << LIMB_BITS) - 1)).to(dtype) for i in range(LIMBS)]


def _recombine(parts: list[torch.Tensor]) -> torch.Tensor:
    out = torch.zeros_like(parts[0], dtype=torch.int64)
    for i, p in enumerate(parts):
        out = out + (torch.round(p).to(torch.int64) << (LIMB_BITS * i))
    return out


def negacyclic_matrix(poly: torch.Tensor) -> torch.Tensor:
    """(..., N) -> (..., N, N) with (x * poly)[j] = sum_i x[i] M[i, j] in
    Z[X]/(X^N + 1)."""
    n = poly.shape[-1]
    i = torch.arange(n, device=poly.device)
    return torch.cat([poly, -poly], dim=-1)[..., (i[None, :] - i[:, None]) % (2 * n)]


def matmul_u64(small: torch.Tensor, rows: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """(B, K) small integers times (K, W) u64 rows, mod 2^64. Exact in
    float64 while K * max|small| * 2^16 < 2^53."""
    lhs = small.to(dtype)
    return _recombine([lhs @ limb for limb in _limbs(rows, dtype)])


def conv_small(small: torch.Tensor, polys: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """sum_d small[:, d] * polys[d, c] in Z_q[X]/(X^N + 1).
    small (B, D, N) integers with D * N * max|small| * 2^16 < 2^53;
    polys (D, C, N) u64 -> (B, C, N). The right-hand side of each limb is
    gathered in one pass as (D, N_i, N_j, C), with -X^k = X^(k+N) read from
    the limb's negated copy."""
    b, d, n = small.shape
    c = polys.shape[1]
    lhs = small.reshape(b, d * n).to(dtype)
    i = torch.arange(n, device=polys.device)
    idx = (i[None, :] - i[:, None]) % (2 * n)
    parts = []
    for limb in _limbs(polys, dtype):
        ext = torch.cat([limb, -limb], dim=-1).transpose(1, 2)  # (D, 2N, C)
        rhs = ext[:, idx, :].reshape(d * n, n * c)
        parts.append((lhs @ rhs).reshape(b, n, c).transpose(1, 2))
        del rhs
    return _recombine(parts)


def rotate(poly: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """poly (B, ..., N) times X^r[b] (exponents mod 2N)."""
    n = poly.shape[-1]
    r = r.reshape(r.shape[0], *([1] * (poly.dim() - 1)))
    idx = (torch.arange(n, device=poly.device) - r) % (2 * n)
    neg = idx >= n
    vals = torch.gather(poly, -1, torch.where(neg, idx - n, idx).expand(poly.shape))
    return torch.where(neg, -vals, vals)


# -- keys -------------------------------------------------------------------------


def _noise(rng: KeyRng, bound_log2: int | None, shape) -> torch.Tensor:
    if bound_log2 is None:
        return torch.zeros(tuple(shape), dtype=torch.int64, device=rng.device)
    return rng.tuniform(bound_log2, shape)


def glwe_mask_times_key(mask: torch.Tensor, sk: torch.Tensor) -> torch.Tensor:
    """sum_j mask[..., j, :] * sk[j] mod 2^64: mask (..., k, N), sk (k, N)."""
    lead = mask.shape[:-2]
    flat = mask.reshape(-1, *mask.shape[-2:])
    out = torch.zeros(flat.shape[0], mask.shape[-1], dtype=torch.int64, device=mask.device)
    for j in range(sk.shape[0]):
        out = out + _binary_conv(flat[:, j], sk[j])
    return out.reshape(*lead, mask.shape[-1])


def _binary_conv(rows: torch.Tensor, bits: torch.Tensor, chunk: int = 8192) -> torch.Tensor:
    """rows (R, N) u64 times the binary polynomial `bits`, mod 2^64."""
    m = negacyclic_matrix(bits.to(torch.float64))
    out = []
    for lo in range(0, rows.shape[0], chunk):
        out.append(_recombine([limb @ m for limb in _limbs(rows[lo:lo + chunk], torch.float64)]))
    return torch.cat(out) if out else rows.clone()


def secret_keys(p: Params, seed: int, device) -> tuple[torch.Tensor, torch.Tensor, KeyRng]:
    """The GLWE and small LWE secret keys, the first two draws."""
    rng = KeyRng(seed, device)
    glwe_sk = rng.binary((p.glwe_dimension, p.polynomial_size))
    lwe_sk = rng.binary((p.lwe_dimension,))
    return glwe_sk, lwe_sk, rng


def keygen(p: Params, seed: int, device) -> Keys:
    glwe_sk, lwe_sk, rng = secret_keys(p, seed, device)
    k, n_poly = p.glwe_dimension, p.polynomial_size
    if p.grouping_factor is None:
        msgs = lwe_sk
    else:
        g = p.grouping_factor
        grp = lwe_sk.reshape(-1, g)
        pats = torch.tensor([[(v >> i) & 1 for i in range(g)] for v in range(1 << g)], device=device)
        msgs = (grp[:, None, :] == pats[None]).all(dim=-1).to(torch.int64).reshape(-1)
    d_rows = (k + 1) * p.pbs_level
    mask = rng.uniform_u64((msgs.numel(), d_rows, k, n_poly))
    e = _noise(rng, p.glwe_noise_log2, (msgs.numel(), d_rows, n_poly))
    body = e + glwe_mask_times_key(mask, glwe_sk)
    bsk = torch.cat([mask, body[:, :, None, :]], dim=2)
    for d in range(d_rows):
        comp, lvl = divmod(d, p.pbs_level)
        bsk[:, d, comp, 0] += msgs << (64 - (lvl + 1) * p.pbs_base_log)
    big_sk = glwe_sk.reshape(-1)
    shifts = torch.tensor([64 - (i + 1) * p.ks_base_log for i in range(p.ks_level)], device=device)
    pts = big_sk[:, None] << shifts[None, :]
    kmask = rng.uniform_u64((p.big_n, p.ks_level, p.lwe_dimension))
    ke = _noise(rng, p.lwe_noise_log2, (p.big_n, p.ks_level))
    kbody = pts + ke + (kmask * lwe_sk).sum(dim=-1)
    ksk = torch.cat([kmask, kbody[..., None]], dim=-1)
    return Keys(glwe_sk=glwe_sk, lwe_sk=lwe_sk, bsk=bsk, ksk=ksk)


# -- encryption, LUTs ---------------------------------------------------------------


def encrypt_big(big_sk: torch.Tensor, pt: torch.Tensor, gen: torch.Generator, noise_log2: int | None) -> torch.Tensor:
    """LWE encryptions of torus values pt (B,) under the big key, masks and
    TUniform noise drawn from the torch generator `gen`."""
    sk = big_sk
    b = pt.shape[0]
    lo, hi = -(2**63), 2**63 - 1
    mask = torch.randint(lo, hi, (b, sk.numel()), generator=gen, device=sk.device, dtype=torch.int64)
    if noise_log2 is None:
        e = torch.zeros(b, dtype=torch.int64, device=sk.device)
    else:
        bnd = 1 << noise_log2
        e = torch.randint(-bnd, bnd + 1, (b,), generator=gen, device=sk.device, dtype=torch.int64)
    body = pt + e + (mask * sk).sum(dim=-1)
    return torch.cat([mask, body[:, None]], dim=-1)


def lut_poly(p: Params, table, device) -> torch.Tensor:
    """The accumulator of a table over [0, msg * carry) as a trivial GLWE
    (k+1, N): each value owns a box of N / (msg * carry) coefficients of
    f(v) * delta, the whole turned back by half a box."""
    n = p.polynomial_size
    box = n // (p.message_modulus * p.carry_modulus)
    vals = torch.repeat_interleave(torch.as_tensor(table, dtype=torch.int64, device=device) * p.delta, box)
    poly = torch.cat([vals[box // 2:], -vals[:box // 2]])
    return torch.cat([poly.new_zeros(p.glwe_dimension, n), poly[None]], dim=0)


def phase(big_sk: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    return ct[..., -1] - (ct[..., :-1] * big_sk).sum(dim=-1)


def decode(p: Params, ph: torch.Tensor, modulus: int) -> torch.Tensor:
    log_delta = int(math.log2(p.delta))
    return srl(ph + (p.delta // 2), log_delta) & (modulus - 1)


# -- the bootstrap -------------------------------------------------------------------


def keyswitch(p: Params, keys: Keys, ct: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    digits = decompose(ct[:, :-1], p.ks_base_log, p.ks_level).reshape(ct.shape[0], -1)
    rows = keys.ksk.reshape(-1, p.lwe_dimension + 1)
    out = -matmul_u64(digits, rows, dtype)
    out[:, -1] += ct[:, -1]
    return out


def _digits(p: Params, acc: torch.Tensor) -> torch.Tensor:
    """acc (B, k+1, N) -> (B, (k+1) * level, N), rows (component, level)."""
    d = decompose(acc, p.pbs_base_log, p.pbs_level)  # (B, k+1, N, level)
    return d.movedim(-1, -2).reshape(acc.shape[0], -1, acc.shape[-1])


def blind_rotate(p: Params, keys: Keys, small: torch.Tensor, lut: torch.Tensor, dtype=torch.float64):
    """small (B, n+1) under the small key, lut (B, k+1, N) -> (B, k+1, N)."""
    n_poly = p.polynomial_size
    log2n = int(math.log2(2 * n_poly))
    ms = mod_switch(small, log2n)
    a, b = ms[:, :-1], ms[:, -1]
    acc = rotate(lut, 2 * n_poly - b)
    k1 = p.glwe_dimension + 1
    if p.grouping_factor is None:
        for j in range(p.lwe_dimension):
            ep = conv_small(_digits(p, acc), keys.bsk[j], dtype)
            acc = acc + rotate(ep, a[:, j]) - ep
        return acc
    g = p.grouping_factor
    v_count = 1 << g
    d_rows = keys.bsk.shape[1]
    for j in range(p.lwe_dimension // g):
        ggsw = keys.bsk[j * v_count:(j + 1) * v_count]  # (V, D, k+1, N)
        polys = ggsw.permute(1, 0, 2, 3).reshape(d_rows, v_count * k1, n_poly)
        ep = conv_small(_digits(p, acc), polys, dtype).reshape(-1, v_count, k1, n_poly)
        grp = a[:, j * g:(j + 1) * g]
        new = ep[:, 0]
        for v in range(1, v_count):
            e = sum(grp[:, i] for i in range(g) if (v >> i) & 1) % (2 * n_poly)
            new = new + rotate(ep[:, v], e)
        acc = new
    return acc


def sample_extract(acc: torch.Tensor) -> torch.Tensor:
    """Coefficient 0 of (B, k+1, N) as LWE under the big key: (B, kN+1)."""
    n = acc.shape[-1]
    mask = acc[:, :-1, :]
    i = torch.arange(n, device=acc.device)
    ext = mask[..., (-i) % n]
    ext = torch.where(i > 0, -ext, ext)
    return torch.cat([ext.reshape(acc.shape[0], -1), acc[:, -1, :1]], dim=-1)


def pbs(p: Params, keys: Keys, ct: torch.Tensor, lut: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """Keyswitch, blind rotation and extraction: (B, kN+1) -> (B, kN+1)."""
    return sample_extract(blind_rotate(p, keys, keyswitch(p, keys, ct, dtype), lut, dtype))
