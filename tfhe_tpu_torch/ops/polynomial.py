"""Exact negacyclic polynomial multiplication mod 2^64 via a 3-prime CRT-NTT.

Counterpart of tfhe_tpu/ops/polynomial.py, in plain PyTorch with no
kernel: no hot path runs it (models/shortint takes the folded engine of
ops/folded_ntt), and it is the ground truth the folded engine is tested
against. Every multiplication in TFHE is (small integer polynomial) x
(u64 torus polynomial); over the three 31-bit primes of DEFAULT_PRIMES the
signed CRT range p1*p2*p3/2 ~ 2^91.6 holds the exact integer convolution
of a full u64 operand with a small one, and Garner's reconstruction
reduces it mod 2^64.

Residues are int64 tensors in [0, p) (p < 2^31, so a product of two fits
in int64); NTT-domain tensors are (..., P, N) int32 holding the same
values; u64 torus polynomials are int64 tensors holding u64 bit patterns.
The two transforms are the JAX package's: `fntt` / `intt`, the merged-twist
radix-2 Cooley-Tukey / Gentleman-Sande pair, and `FourStepNtt`, whose DFT
matrices multiply as four 8-bit limb planes of each operand in one float64
matmul (every digit-pair sum stays below 2^22, so it is exact on the CPU
and on the card) and recombine mod p with the weights 2^(8(a+b)). Both are
exact mod p, so their outputs equal the JAX package's bit for bit.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from tfhe_tpu_torch import _device, _u64

# NTT-friendly primes: 2^14 | p-1, so negacyclic transforms up to N=8192.
# p1 = 15*2^27+1, p2 = 27*2^26+1, p3 = 63*2^25+1; all < 2^31.
DEFAULT_PRIMES = (2013265921, 1811939329, 2113929217)
DEFAULT_LIMB_BITS = 16  # the JAX package's; kept for its call order, unused by the CRT


def _is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 2^64."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _primitive_root(p: int) -> int:
    """Smallest primitive root of Z_p^* (p prime)."""
    factors = []
    phi = p - 1
    m = phi
    f = 2
    while f * f <= m:
        if m % f == 0:
            factors.append(f)
            while m % f == 0:
                m //= f
        f += 1
    if m > 1:
        factors.append(m)
    for g in range(2, p):
        if all(pow(g, phi // q, p) != 1 for q in factors):
            return g
    raise RuntimeError("no primitive root")


def _bitrev_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _ntt_tables(p: int, n: int):
    """Host twiddle tables (numpy int64) for prime p and size n:
    (psi^bitrev(i), psi^-bitrev(i), n^-1 mod p), psi a primitive 2n-th
    root of unity (the negacyclic twist merged into the butterflies)."""
    assert _is_prime(p), f"{p} is not prime"
    assert (p - 1) % (2 * n) == 0, f"2N={2 * n} does not divide p-1 for p={p}"
    g = _primitive_root(p)
    psi = pow(g, (p - 1) // (2 * n), p)
    assert pow(psi, n, p) == p - 1  # primitive 2n-th root: psi^n = -1
    psi_inv = pow(psi, p - 2, p)
    pw = np.empty(n, dtype=np.int64)
    pw_inv = np.empty(n, dtype=np.int64)
    cur, cur_inv = 1, 1
    for i in range(n):
        pw[i], pw_inv[i] = cur, cur_inv
        cur = cur * psi % p
        cur_inv = cur_inv * psi_inv % p
    rev = _bitrev_indices(n)
    return pw[rev], pw_inv[rev], pow(n, p - 2, p)


def _as_table(t, like: torch.Tensor) -> torch.Tensor:
    """A twiddle table (numpy or tensor) as int64 on `like`'s device."""
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.asarray(t, dtype=np.int64))
    return t.to(device=like.device, dtype=torch.int64)


def _addmod(a, b, p: int):
    s = a + b
    return torch.where(s >= p, s - p, s)


def _submod(a, b, p: int):
    s = a + (p - b)
    return torch.where(s >= p, s - p, s)


def fntt(a: torch.Tensor, psi_rev, p: int) -> torch.Tensor:
    """Forward negacyclic NTT (Cooley-Tukey, natural -> bit-reversed order).
    a: (..., N) int64 residues < p."""
    n = a.shape[-1]
    lead = a.shape[:-1]
    psi_rev = _as_table(psi_rev, a)
    t, m = n, 1
    while m < n:
        t //= 2
        a = a.reshape(*lead, m, 2, t)
        s = psi_rev[m : 2 * m].reshape(m, 1)
        u = a[..., 0, :]
        v = a[..., 1, :] * s % p
        a = torch.stack([_addmod(u, v, p), _submod(u, v, p)], dim=-2).reshape(*lead, n)
        m *= 2
    return a


def intt(a: torch.Tensor, psi_inv_rev, n_inv: int, p: int) -> torch.Tensor:
    """Inverse negacyclic NTT (Gentleman-Sande, bit-reversed -> natural)."""
    n = a.shape[-1]
    lead = a.shape[:-1]
    psi_inv_rev = _as_table(psi_inv_rev, a)
    t, m = 1, n
    while m > 1:
        h = m // 2
        a = a.reshape(*lead, h, 2, t)
        s = psi_inv_rev[h : 2 * h].reshape(h, 1)
        u = a[..., 0, :]
        v = a[..., 1, :]
        a = torch.stack([_addmod(u, v, p), _submod(u, v, p) * s % p], dim=-2).reshape(*lead, n)
        t *= 2
        m = h
    return a * int(n_inv) % p


class FourStepNtt:
    """Negacyclic NTT mod p by the four-step algorithm: psi pre-twist,
    column DFT (W_R), twiddle omega^(rc), row DFT (W_C), with N = R x C.
    The DFT matmuls run on four 8-bit limb planes of both operands (module
    docstring). Output is the transposed four-step order; `backward`
    consumes it."""

    def __init__(self, p: int, n: int, device=None):
        self.p = p
        self.n = n
        self.device = _device.resolve(device)
        r = 1
        while r * r < n:
            r *= 2
        c = n // r
        assert r * c == n and r <= 64 and c <= 64, f"unsupported N={n}"
        self.r_dim, self.c_dim = r, c
        g = _primitive_root(p)
        psi = pow(g, (p - 1) // (2 * n), p)
        omega = psi * psi % p  # primitive N-th root
        n_inv = pow(n, p - 2, p)
        psi_inv = pow(psi, p - 2, p)
        omega_inv = pow(omega, p - 2, p)
        dev = self.device
        as_dev = lambda x: torch.from_numpy(np.asarray(x, dtype=np.int64)).to(dev)
        self.psi_pow = as_dev([pow(psi, i, p) for i in range(n)])
        self.psi_inv_ninv_pow = as_dev([pow(psi_inv, i, p) * n_inv % p for i in range(n)])
        self.twiddle = as_dev([[pow(omega, a * b, p) for b in range(c)] for a in range(r)])
        self.twiddle_inv = as_dev([[pow(omega_inv, a * b, p) for b in range(c)] for a in range(r)])
        om_r, om_c = pow(omega, c, p), pow(omega, r, p)
        self.w_r = self._limb_matrix(om_r, r)
        self.w_r_inv = self._limb_matrix(pow(om_r, p - 2, p), r)
        self.w_c = self._limb_matrix(om_c, c)
        self.w_c_inv = self._limb_matrix(pow(om_c, p - 2, p), c)
        # recombination weights 2^(8k) mod p, k = a + b
        self.limb_w = [pow(2, 8 * k, p) for k in range(7)]

    def _limb_matrix(self, root: int, dim: int) -> torch.Tensor:
        """(4, dim, dim) float64: the four 8-bit limb planes of the DFT
        matrix W[j, i] = root^(ij) mod p."""
        w = np.array([[pow(root, i * j, self.p) for i in range(dim)] for j in range(dim)], dtype=np.int64)
        limbs = np.stack([(w >> (8 * a)) & 0xFF for a in range(4)], axis=0)
        return torch.from_numpy(limbs.astype(np.float64)).to(self.device)

    def _mod_matmul(self, w_limbs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """W @ x mod p along the second-to-last axis of x: (..., D, C)."""
        xl = torch.stack([(x >> (8 * b)) & 0xFF for b in range(4)], dim=-3).to(torch.float64)  # (..., 4, D, C)
        m = torch.einsum("aji,...bic->...abjc", w_limbs, xl).to(torch.int64)  # exact, < 2^22
        acc = None
        for k in range(7):
            mk = None
            for a in range(max(0, k - 3), min(4, k + 1)):
                blk = m[..., a, k - a, :, :]
                mk = blk if mk is None else mk + blk
            term = mk * self.limb_w[k]  # < 2^24 * 2^31
            acc = term if acc is None else acc + term
        return acc % self.p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., N) int64 residues < p -> (..., N) NTT values (four-step order)."""
        r, c = self.r_dim, self.c_dim
        y = (x * self.psi_pow % self.p).reshape(*x.shape[:-1], r, c)
        y = self._mod_matmul(self.w_r, y)  # column DFT
        y = y * self.twiddle % self.p
        y = self._mod_matmul(self.w_c, y.transpose(-1, -2))  # row DFT: (..., C, R)
        return y.reshape(*x.shape[:-1], self.n)

    def backward(self, f: torch.Tensor) -> torch.Tensor:
        """Inverse of `forward` (consumes the four-step order)."""
        r, c = self.r_dim, self.c_dim
        y = self._mod_matmul(self.w_c_inv, f.reshape(*f.shape[:-1], c, r))
        y = y.transpose(-1, -2) * self.twiddle_inv % self.p  # (..., R, C)
        y = self._mod_matmul(self.w_r_inv, y).reshape(*f.shape[:-1], self.n)
        return y * self.psi_inv_ninv_pow % self.p


class NegacyclicEngine:
    """Exact negacyclic polymul mod 2^64: (small int poly) x (u64 torus
    poly) over a 3-prime CRT. `forward_u64` transforms the u64 operand,
    `forward_small` the small one; products accumulate in the transform
    domain and `backward` reconstructs them. `limb_bits` is stored as the
    JAX package stores it and changes nothing. `device` (keyword-only) is
    where its tables live (default "cuda"; pass "cpu" to run without a
    card)."""

    def __init__(
        self,
        n: int,
        primes: Sequence[int] = DEFAULT_PRIMES,
        limb_bits: int = DEFAULT_LIMB_BITS,
        ntt_impl: str = "four_step",
        *,
        device=None,
    ):
        assert n & (n - 1) == 0, "N must be a power of two"
        self.n = n
        self.primes = tuple(primes)
        self.limb_bits = limb_bits
        self.n_limbs = 64 // limb_bits
        assert 64 % limb_bits == 0
        self.device = _device.resolve(device)
        tabs = [_ntt_tables(p, n) for p in self.primes]
        self._psi = [torch.from_numpy(t[0]).to(self.device) for t in tabs]
        self._psi_inv = [torch.from_numpy(t[1]).to(self.device) for t in tabs]
        self._n_inv = [t[2] for t in tabs]
        # "four_step" is the JAX package's MXU form; "radix2" the butterflies.
        # A key transformed under one ordering must be consumed under the same.
        if ntt_impl == "four_step" and 4 <= n <= 4096:
            self._ntts = [FourStepNtt(p, n, self.device) for p in self.primes]
        else:
            self._ntts = None
        self.ntt_impl = "four_step" if self._ntts else "radix2"
        assert len(self.primes) == 3, "engine uses a 3-prime CRT"
        p1, p2, p3 = self.primes
        prod = p1 * p2 * p3
        self._inv_p1_mod_p2 = pow(p1, p2 - 2, p2)
        self._inv_p1p2_mod_p3 = pow(p1 * p2 % p3, p3 - 2, p3)
        self._prod_mod64 = _u64.const(prod)
        half = prod // 2
        self._h3 = half // (p1 * p2)
        self._h2 = half % (p1 * p2) // p1
        self._h1 = half % p1
        # signed CRT headroom: N * |a| * |b| must stay below prod/2
        self.max_product_bits = int(np.floor(np.log2(prod / 2) - np.log2(n)))

    def _fwd(self, x: torch.Tensor, i: int) -> torch.Tensor:
        if self._ntts is not None:
            return self._ntts[i].forward(x)
        return fntt(x, self._psi[i], self.primes[i])

    def _bwd(self, x: torch.Tensor, i: int) -> torch.Tensor:
        if self._ntts is not None:
            return self._ntts[i].backward(x)
        return intt(x, self._psi_inv[i], self._n_inv[i], self.primes[i])

    # -- forward transforms -------------------------------------------------

    def forward_small(self, a: torch.Tensor) -> torch.Tensor:
        """Small signed polynomials (int64, or u64 two's complement of
        small values): (..., N) -> (..., P, N) int32 residues."""
        a = a.to(torch.int64)
        out = [self._fwd(torch.remainder(a, p), i) for i, p in enumerate(self.primes)]
        return torch.stack(out, dim=-2).to(torch.int32)

    def forward_u64(self, b: torch.Tensor) -> torch.Tensor:
        """u64 torus polynomials: (..., N) int64 -> (..., P, N) int32
        residues. The exact convolution against the other operand must stay
        below 2^max_product_bits."""
        return torch.stack([self._fwd(_u64.umod(b, p), i) for i, p in enumerate(self.primes)], dim=-2).to(
            torch.int32
        )

    # -- transform-domain algebra -------------------------------------------

    def pointwise_mul(self, fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
        """(..., P, N) x (..., P, N) residues -> their products mod p."""
        out = [fa[..., i, :].to(torch.int64) * fb[..., i, :].to(torch.int64) % p for i, p in enumerate(self.primes)]
        return torch.stack(out, dim=-2).to(torch.int32)

    def add_domain(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Add two transform-domain tensors (residues mod each prime)."""
        out = [_addmod(x[..., i, :].to(torch.int64), y[..., i, :].to(torch.int64), p) for i, p in enumerate(self.primes)]
        return torch.stack(out, dim=-2).to(torch.int32)

    # -- inverse + reconstruction --------------------------------------------

    def crt_reconstruct(self, r: list) -> torch.Tensor:
        """Garner's mixed-radix reconstruction of the exact signed value
        from residues (int64 in [0, p_i)), reduced mod 2^64 (int64)."""
        r1, r2, r3 = r
        p1, p2, p3 = self.primes
        v1 = r1
        v2 = _submod(r2, v1 % p2, p2) * self._inv_p1_mod_p2 % p2
        lo_mod_p3 = (v1 + (p1 % p3) * v2) % p3  # x mod p3 = v1 + p1*v2 (mod p3)
        v3 = _submod(r3, lo_mod_p3, p3) * self._inv_p1p2_mod_p3 % p3
        # x = v1 + p1*(v2 + p2*v3) < p1*p2*p3: its Horner form wraps to x mod 2^64
        x = v1 + p1 * (v2 + p2 * v3)
        neg = (v3 > self._h3) | ((v3 == self._h3) & ((v2 > self._h2) | ((v2 == self._h2) & (v1 > self._h1))))
        return x - torch.where(neg, self._prod_mod64, 0)

    def backward(self, f: torch.Tensor, shift: int = 0) -> torch.Tensor:
        """Inverse-transform (..., P, N) residues, reconstruct the exact
        value by CRT, reduce mod 2^64 and scale by 2^shift."""
        f = f.to(torch.int64)
        x = self.crt_reconstruct([self._bwd(f[..., i, :], i) for i in range(len(self.primes))])
        return x << shift if shift else x

    # -- convenience ----------------------------------------------------------

    def polymul(self, a_small: torch.Tensor, b_u64: torch.Tensor) -> torch.Tensor:
        """Negacyclic product mod 2^64 of a small polynomial (|a| <= 2^16)
        and a u64 polynomial; shapes broadcast over leading dims."""
        return self.backward(self.pointwise_mul(self.forward_small(a_small), self.forward_u64(b_u64)))


@functools.lru_cache(maxsize=None)
def _engine_cached(n: int, device: str, primes: tuple, limb_bits: int, ntt_impl: str) -> NegacyclicEngine:
    return NegacyclicEngine(n, primes, limb_bits, ntt_impl, device=device)


def get_engine(
    n: int,
    primes: Sequence[int] = DEFAULT_PRIMES,
    limb_bits: int = DEFAULT_LIMB_BITS,
    ntt_impl: str = "four_step",
    *,
    device=None,
) -> NegacyclicEngine:
    """The cached engine for (n, device, primes, limb_bits, ntt_impl);
    `device` (keyword-only) defaults to "cuda", as the port's other entry
    points."""
    return _engine_cached(n, str(_device.resolve(device)), tuple(primes), limb_bits, ntt_impl)


def negacyclic_polymul_reference(a, b, q: int = 2**64) -> np.ndarray:
    """Slow exact ground truth with Python integers (tests only).
    a, b: 1-D integer sequences. Returns a numpy object array of the
    negacyclic product mod q."""
    n = len(a)
    a = [int(x) for x in a]
    b = [int(x) for x in b]
    out = [0] * n
    for i in range(n):
        for j in range(n):
            k = i + j
            if k < n:
                out[k] = (out[k] + a[i] * b[j]) % q
            else:
                out[k - n] = (out[k - n] - a[i] * b[j]) % q
    return np.array(out, dtype=object)
