"""Folded four-step negacyclic NTT over a 3-prime CRT: exact polymul mod 2^64.

Counterpart of tfhe_tpu/ops/folded_ntt.py. The plain PyTorch engine here
mirrors the JAX math step by step: with the index split i = r + R*c,
j = C*s + t (N = R*C) the negacyclic twist and all mid twiddles fold into
two constant DFT matrices per prime,

    ahat[C*s+t] = sum_r M_t[s,r] * (sum_c V[t,c] * a[r+R*c]),

operands are split into balanced base-256 digit planes so every stage is
an exact float64 matmul (digit products summed stay below 2^24), and the
digit blocks are recombined mod p with u32 Shoup reductions on int64
lanes. The output is the *folded layout*: slot h = t*R + s holds
a(psi^(2j+1)) mod p for j = C*s + t, lazily reduced to [0, 2p).

NTT-domain tensors are (..., P, N) int32 holding u32 residues; key
material from `make_shoup` is (..., P, 2, N) int32 (value, Shoup
companion floor(value * 2^32 / p)).

On a CUDA tensor `forward_small`, `forward_u64` and `backward` run the
hand-written kernels K1 (forward) and K2 (inverse) of ops/ntt_cuda.py;
on a CPU tensor they run the plain transforms below.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tfhe_tpu_torch import _device, _u64
from tfhe_tpu_torch._u64 import MASK32, condsub, mulhi_u32, shoup_mulmod

# ascending, all < 2^30, 2^13 | p-1 (negacyclic N up to 4096):
# 469762049 = 7*2^26+1, 754974721 = 45*2^24+1, 998244353 = 119*2^23+1
FOLDED_PRIMES = (469762049, 754974721, 998244353)

_F = torch.float64  # digit-plane matmuls: exact for sums below 2^53


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


class _PrimeCtx:
    """Per-prime constants for Shoup/Barrett arithmetic (Python ints)."""

    def __init__(self, p: int):
        self.p = p
        self.two_p = 2 * p

        def pair(w: int):
            w %= p
            return (w, (w << 32) // p, (1 << 32) * w % p)

        # (w, w_shoup, neg-correction 2^32*w mod p)
        self.one = pair(1)
        self.c16 = pair(1 << 16)
        self.c32 = pair(1 << 32)
        self.c48 = pair(1 << 48)

    def reduce_signed(self, t: torch.Tensor, c) -> torch.Tensor:
        """(i32 t) * c.w mod p -> [0, 2p). The same approximate mulhi as
        the JAX engine (low-low partial product dropped, residue in
        [0, 3p) before the fix-up), so the lazy residues agree bit for bit."""
        w, ws, corr = c
        a = t & MASK32
        a0 = a & 0xFFFF
        a1 = a >> 16
        b0 = ws & 0xFFFF
        b1 = ws >> 16
        lh = a0 * b1
        hl = a1 * b0
        tt = (lh & 0xFFFF) + (hl & 0xFFFF)
        q = a1 * b1 + (lh >> 16) + (hl >> 16) + (tt >> 16)
        r = a * w - q * self.p  # in [0, 3p)
        fix = torch.where(t < 0, self.p - corr % self.p, 0)
        return condsub(r + fix, self.two_p)

    def reduce_u64_pair(self, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
        """(lo + 2^32*hi) mod p -> [0, 2p), u32 inputs on int64 lanes."""
        w, ws, _ = self.one
        r0 = shoup_mulmod(lo, w, ws, self.p)
        w2, ws2, _ = self.c32
        r1 = shoup_mulmod(hi, w2, ws2, self.p)
        return condsub(r0 + r1, self.two_p)


def _split_signed(x: torch.Tensor, nplanes: int) -> torch.Tensor:
    """Balanced base-256 digits of int32 values: (..., nplanes) with
    |d| <= 128 and sum(d_k * 256^k) == x. 4 planes cover |x| < 2^31,
    3 cover |x| <= 2^23."""
    ds = []
    v = x
    for _ in range(nplanes - 1):
        d = ((v + 128) & 255) - 128
        ds.append(d)
        v = (v - d) >> 8
    ds.append(v)
    return torch.stack(ds, dim=-1).to(_F)


def _balanced_digits_host(m: np.ndarray, p: int, nplanes: int) -> np.ndarray:
    """Matrix entries in [0, p) -> centered, then balanced base-256 digits."""
    v = m.astype(np.int64)
    v = np.where(v > p // 2, v - p, v)
    out = np.empty(m.shape + (nplanes,), dtype=np.int64)
    for k in range(nplanes - 1):
        d = ((v + 128) & 255) - 128
        out[..., k] = d
        v = (v - d) >> 8
    out[..., nplanes - 1] = v
    assert np.abs(out).max() <= 128
    return out.astype(np.float64)


def _factor(n: int) -> tuple[int, int]:
    """N = R*C with R = 128 where possible (the JAX engine's split, which
    fixes the folded layout)."""
    if n >= 256:
        return 128, n // 128
    r = 1
    while r * r < n:
        r *= 2
    return r, n // r


class FoldedNtt:
    """Negacyclic NTT mod one prime with all twiddles folded into two
    constant digit-plane matrices (module docstring)."""

    def __init__(self, p: int, n: int, device: torch.device):
        assert _is_prime(p) and (p - 1) % (2 * n) == 0
        assert p < 2**30, "lazy [0, 2p) residue arithmetic needs p < 2^30"
        self.p = p
        self.n = n
        self.ctx = _PrimeCtx(p)
        self.na = 3 if p <= 16580352 else 4
        r, c = _factor(n)
        self.r_dim, self.c_dim = r, c
        assert max(r, c) <= 128, f"N={n} too large for the digit scheme"
        self._big_r = r > 64
        self._big_c = c > 64

        g = _primitive_root(p)
        self.psi = pow(g, (p - 1) // (2 * n), p)
        two_n = 2 * n
        # every table entry is a power of psi: look exponents up mod 2N
        pw = np.empty(two_n, dtype=np.int64)
        v = 1
        for e in range(two_n):
            pw[e] = v
            v = v * self.psi % p
        fwd = lambda e: pw[np.asarray(e) % two_n]
        inv = lambda e: pw[(-np.asarray(e)) % two_n]
        n_inv = pow(n, p - 2, p)
        t_ = np.arange(c)
        cc = np.arange(c)
        s_ = np.arange(r)
        rr = np.arange(r)
        # V[t, c'] = w_C^{c't} psi^{Rc'};  M[t, s, r'] = w_R^{r's} w^{r't} psi^{r'}
        ev = 2 * r * t_[:, None] * cc[None, :] + r * cc[None, :]
        em = (
            2 * c * rr[None, None, :] * s_[None, :, None]
            + 2 * rr[None, None, :] * t_[:, None, None]
            + rr[None, None, :]
        )
        # Mi[t, r', s] = (that exponent negated) / N;  Vi[c', t] = inverse of V
        emi = np.transpose(em, (0, 2, 1))
        evi = np.transpose(ev, (1, 0))
        v_tab = fwd(ev)
        m_tab = fwd(em)
        mi_tab = inv(emi) * n_inv % p
        vi_tab = inv(evi)

        na = self.na
        as_dev = lambda x: torch.from_numpy(_balanced_digits_host(x, p, na)).to(device)
        self.v_l = as_dev(v_tab)  # (C, C, na)
        self.m_l = as_dev(m_tab)  # (C, R, R, na)
        self.mi_l = as_dev(mi_tab)  # (C, R, R, na)
        self.vi_l = as_dev(vi_tab)  # (C, C, na)

    def _recombine(self, blocks: torch.Tensor, big: bool = False) -> torch.Tensor:
        """blocks: (..., na, D1, D2, nb) exact digit-pair dot products;
        returns (..., D1, D2) in [0, 2p) congruent to
        sum_{a,b} blocks * 256^(a+b) (the JAX engine's grouping)."""
        b = blocks.to(torch.int64)
        na = b.shape[-4]
        nb = b.shape[-1]
        blk = lambda a, bb: b[..., a, :, :, bb]
        split3 = big and na == 4 and nb == 4
        s = [None] * (na + nb - 1)
        for a in range(na):
            for bb in range(nb):
                if split3 and a + bb == 3:
                    continue
                k = a + bb
                s[k] = blk(a, bb) if s[k] is None else s[k] + blk(a, bb)
        ctx = self.ctx
        r1b = None
        if split3:
            s[3] = blk(0, 3) + blk(1, 2)
            r1b = ctx.reduce_signed((blk(2, 1) + blk(3, 0)) << 8, ctx.c16)
        while len(s) < 8:
            s.append(None)
        consts = (ctx.one, ctx.c16, ctx.c32, ctx.c48)
        out = None
        for j in range(4):
            lo, hi = s[2 * j], s[2 * j + 1]
            if lo is None and hi is None:
                continue
            t = lo if hi is None else ((hi << 8) if lo is None else lo + (hi << 8))
            r = ctx.reduce_signed(t, consts[j])
            out = r if out is None else condsub(out + r, ctx.two_p)
        if r1b is not None:
            out = condsub(out + r1b, ctx.two_p)
        return out

    def _center(self, r: torch.Tensor) -> torch.Tensor:
        """Residues in [0, 2p) -> centered in [-p/2, p/2]."""
        c = condsub(r, self.p)
        return c - torch.where(c > self.p // 2, self.p, 0)

    def _mid_planes(self, y: torch.Tensor) -> torch.Tensor:
        if self.na == 3:
            return _split_signed(self._center(y), 3)
        return _split_signed(y, 4)

    def forward_planes(self, xl: torch.Tensor) -> torch.Tensor:
        """xl: (..., C, R, nb) digit planes of a[r + R*c] at [..., c, r].
        Returns (..., N) int64 in [0, 2p), folded layout."""
        y = torch.einsum("tca,...crb->...atrb", self.v_l, xl)
        y = self._recombine(y, big=self._big_c)
        z = torch.einsum("tsra,...trb->...atsb", self.m_l, self._mid_planes(y))
        out = self._recombine(z, big=self._big_r)
        return out.reshape(*out.shape[:-2], self.n)

    def forward_signed(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., N) int64 holding |x| < 2^31. Returns (..., N) in [0, 2p)."""
        xm = x.reshape(*x.shape[:-1], self.c_dim, self.r_dim)
        return self.forward_planes(_split_signed(xm, 4))

    def inverse(self, f: torch.Tensor) -> torch.Tensor:
        """f: (..., N) int64 u32 values < 2^31, folded layout. Returns
        (..., N) canonical residues in [0, p), natural order."""
        fm = f.reshape(*f.shape[:-1], self.c_dim, self.r_dim)
        if self.na == 3:
            fl = _split_signed(self._center(fm), 3)
        else:
            fl = _split_signed(fm, 4)
        u = torch.einsum("trsa,...tsb->...atrb", self.mi_l, fl)
        u = self._recombine(u, big=self._big_r)
        a = torch.einsum("cta,...trb->...acrb", self.vi_l, self._mid_planes(u))
        a = self._recombine(a, big=self._big_c)
        a = condsub(a, self.p)
        return a.reshape(*a.shape[:-2], self.n)


class GarnerConsts:
    """Mixed-radix (Garner) constants for x = v0 + p0(v1 + p1(v2 + ...))."""

    def __init__(self, primes):
        self.primes = tuple(primes)
        self.np = len(primes)
        prod = 1
        for p in primes:
            prod *= p
        self.prod = prod

        def pair(w: int, p: int):
            w %= p
            return (w, (w << 32) // p)

        # inv[i] = (prod_{j<i} p_j)^{-1} mod p_i; pmod[i][j] = p_j mod p_i
        self.inv: list = [None] * self.np
        self.pmod: list = [[None] * self.np for _ in range(self.np)]
        for i in range(1, self.np):
            pi = primes[i]
            prodi = 1
            for j in range(i):
                prodi *= primes[j]
            self.inv[i] = pair(pow(prodi % pi, pi - 2, pi), pi)
            for j in range(i):
                self.pmod[i][j] = pair(primes[j], pi)
        # mixed-radix digits of prod // 2 (negative-range threshold)
        t = prod // 2
        hs = []
        for p in primes:
            hs.append(t % p)
            t //= p
        self.h = tuple(hs)


class FoldedCrtEngine:
    """Exact negacyclic polymul mod 2^64 over FOLDED_PRIMES on one device."""

    def __init__(self, n: int, device: torch.device):
        assert n & (n - 1) == 0
        self.n = n
        self.device = device
        self.primes = FOLDED_PRIMES
        self.n_primes = len(self.primes)
        self.ntts = [FoldedNtt(p, n, device) for p in self.primes]
        prod = 1
        for p in self.primes:
            prod *= p
        self.max_product_bits = int(np.floor(np.log2(prod / 2) - np.log2(n)))
        self.garner = GarnerConsts(self.primes)

    def _check(self, x: torch.Tensor):
        if x.device.type != self.device.type:
            raise ValueError(f"tensor on {x.device}, engine on {self.device}")

    # -- forward --------------------------------------------------------------

    def forward_small(self, a: torch.Tensor) -> torch.Tensor:
        """Small signed polynomials (|a| <= 2^23): (..., N) int ->
        (..., P, N) int32 residues in [0, 2p_i). Three digit planes."""
        self._check(a)
        if a.is_cuda:
            from tfhe_tpu_torch.ops import ntt_cuda

            return ntt_cuda.forward(self, a, small=True)
        return self.forward_small_plain(a)

    def forward_small_plain(self, a: torch.Tensor) -> torch.Tensor:
        a = _u64.trunc_i32(a)
        am = a.reshape(*a.shape[:-1], self.ntts[0].c_dim, self.ntts[0].r_dim)
        planes = _split_signed(am, 3)
        return _u64.to_i32(
            torch.stack([ntt.forward_planes(planes) for ntt in self.ntts], dim=-2)
        )

    def forward_i32_plain(self, a: torch.Tensor) -> torch.Tensor:
        """forward of |a| < 2^31 through four digit planes (the nb=4 form
        of the JAX kernel): (..., N) -> (..., P, N) int32 in [0, 2p)."""
        a = _u64.trunc_i32(a)
        return _u64.to_i32(
            torch.stack([ntt.forward_signed(a) for ntt in self.ntts], dim=-2)
        )

    def forward_u64(self, b: torch.Tensor) -> torch.Tensor:
        """u64 torus polynomials: (..., N) int64 -> (..., P, N) int32."""
        self._check(b)
        if b.is_cuda:
            from tfhe_tpu_torch.ops import ntt_cuda

            return ntt_cuda.forward(self, b, small=False)
        return self.forward_u64_plain(b)

    def forward_u64_plain(self, b: torch.Tensor) -> torch.Tensor:
        lo = b & MASK32
        hi = _u64.srl(b, 32)
        outs = []
        for ntt in self.ntts:
            r = ntt.ctx.reduce_u64_pair(lo, hi)  # [0, 2p) < 2^31
            outs.append(ntt.forward_signed(r))
        return _u64.to_i32(torch.stack(outs, dim=-2))

    def make_shoup(self, f: torch.Tensor) -> torch.Tensor:
        """(..., P, N) residues -> (..., P, 2, N) int32 (canonical value,
        floor(value * 2^32 / p))."""
        vals, shoups = [], []
        for i, ntt in enumerate(self.ntts):
            v = condsub(_u64.u32(f[..., i, :]), ntt.p)
            vals.append(v)
            shoups.append((v << 32) // ntt.p)
        return _u64.to_i32(
            torch.stack([torch.stack(vals, dim=-2), torch.stack(shoups, dim=-2)], dim=-2)
        )

    # -- transform-domain algebra ----------------------------------------------

    def pointwise_shoup(self, fa: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        """fa: (..., P, N) any u32; key: (..., P, 2, N) from make_shoup.
        Returns (..., P, N) int32 in [0, 2p_i)."""
        outs = []
        for i, ntt in enumerate(self.ntts):
            outs.append(
                shoup_mulmod(
                    _u64.u32(fa[..., i, :]),
                    _u64.u32(key[..., i, 0, :]),
                    _u64.u32(key[..., i, 1, :]),
                    ntt.p,
                )
            )
        return _u64.to_i32(torch.stack(outs, dim=-2))

    def pointwise_mul(self, fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
        """Generic mulmod of two residue tensors -> [0, 2p)."""
        outs = []
        for i, ntt in enumerate(self.ntts):
            a = condsub(_u64.u32(fa[..., i, :]), ntt.p)
            b = condsub(_u64.u32(fb[..., i, :]), ntt.p)
            outs.append(ntt.ctx.reduce_u64_pair((a * b) & MASK32, mulhi_u32(a, b)))
        return _u64.to_i32(torch.stack(outs, dim=-2))

    def add_domain(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Lazy addmod of [0, 2p) residues -> [0, 2p)."""
        outs = []
        for i, ntt in enumerate(self.ntts):
            outs.append(condsub(_u64.u32(x[..., i, :]) + _u64.u32(y[..., i, :]), ntt.ctx.two_p))
        return _u64.to_i32(torch.stack(outs, dim=-2))

    def condsub_domain(self, x: torch.Tensor) -> torch.Tensor:
        """[0, 4p) -> [0, 2p)."""
        outs = []
        for i, ntt in enumerate(self.ntts):
            outs.append(condsub(_u64.u32(x[..., i, :]), ntt.ctx.two_p))
        return _u64.to_i32(torch.stack(outs, dim=-2))

    def reduce_u64_domain(self, s: torch.Tensor, canonical: bool = False) -> torch.Tensor:
        """Unreduced u64 sums (..., P, N) -> int32 residues in [0, 2p)
        (or [0, p) with canonical=True)."""
        lo = s & MASK32
        hi = _u64.srl(s, 32)
        outs = []
        for i, ntt in enumerate(self.ntts):
            r = ntt.ctx.reduce_u64_pair(lo[..., i, :], hi[..., i, :])
            if canonical:
                r = condsub(r, ntt.p)
            outs.append(r)
        return _u64.to_i32(torch.stack(outs, dim=-2))

    # -- inverse + CRT ----------------------------------------------------------

    def crt_reconstruct(self, r: list) -> torch.Tensor:
        """Garner: canonical residues per prime -> the signed CRT value
        mod 2^64 (int64)."""
        g = self.garner
        r = [_u64.u32(x) for x in r]
        v = [r[0]]
        for i in range(1, g.np):
            p = self.primes[i]
            two_p = 2 * p
            t = v[i - 1]
            for j in range(i - 2, -1, -1):
                w, ws = g.pmod[i][j]
                t = condsub(shoup_mulmod(t, w, ws, p) + v[j], two_p)
            d = r[i] + two_p - condsub(t, two_p)
            w, ws = g.inv[i]
            v.append(condsub(shoup_mulmod(d, w, ws, p), p))
        x = v[-1]
        for j in range(g.np - 2, -1, -1):
            x = v[j] + self.primes[j] * x
        neg = v[-1] > g.h[-1]
        eq = v[-1] == g.h[-1]
        for j in range(g.np - 2, -1, -1):
            neg = neg | (eq & (v[j] > g.h[j]))
            eq = eq & (v[j] == g.h[j])
        return x - torch.where(neg, _u64.const(g.prod), 0)

    def inverse_plain(self, f: torch.Tensor) -> torch.Tensor:
        """(..., P, N) u32 < 2^31 -> (..., P, N) int32 canonical residues."""
        return _u64.to_i32(
            torch.stack(
                [ntt.inverse(_u64.u32(f[..., i, :])) for i, ntt in enumerate(self.ntts)],
                dim=-2,
            )
        )

    def backward(self, f: torch.Tensor, shift: int = 0) -> torch.Tensor:
        """(..., P, N) residues (< 2^31) -> (..., N) int64 coefficients."""
        self._check(f)
        if f.is_cuda:
            from tfhe_tpu_torch.ops import ntt_cuda

            res = ntt_cuda.inverse(self, f)
        else:
            res = self.inverse_plain(f)
        x = self.crt_reconstruct([res[..., i, :] for i in range(self.n_primes)])
        return x << shift if shift else x

    def polymul(self, a_small: torch.Tensor, b_u64: torch.Tensor) -> torch.Tensor:
        fa = self.forward_small(a_small)
        fb = self.forward_u64(b_u64)
        return self.backward(self.pointwise_mul(fa, fb))


@functools.lru_cache(maxsize=None)
def _engine_cached(n: int, device: str) -> FoldedCrtEngine:
    return FoldedCrtEngine(n, torch.device(device))


def get_folded_engine(n: int, device=None) -> FoldedCrtEngine:
    """The engine for polynomial size n on `device` (default "cuda")."""
    dev = _device.resolve(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
    return _engine_cached(n, str(dev))
