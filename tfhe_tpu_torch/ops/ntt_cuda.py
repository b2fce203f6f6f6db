"""Wrappers of kernels K1 (forward NTT) and K2 (inverse NTT), csrc/ntt.cu.

K1 replaces tfhe_tpu/ops/pallas_ntt.py make_pallas_ntt `forward`
(pallas_call at pallas_ntt.py:494); K2 its `inverse` (pallas_ntt.py:518).
Their plain PyTorch versions are FoldedCrtEngine.forward_small_plain /
forward_i32_plain / forward_u64_plain and inverse_plain
(ops/folded_ntt.py), which mirror the JAX transforms. The wrappers take
CUDA tensors only: on anything else they raise. Each counts its launches
in `<wrapper>.launches`. The module also builds the constant tables every
kernel reads: the twiddle rows (`kernel_tables`), the per-prime Shoup
constants of the `%`-free reductions and the constants of `garner_u32`
(`garner_consts_shoup`) and, for the rotation kernels K3 and K4, the
powers of psi (`psi_powers`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tfhe_tpu_torch import _build
from tfhe_tpu_torch._u64 import MASK32

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("ntt")
    lib.tfhe_ntt_forward.argtypes = [_P, _I, _P, _I, _I, _I, _I, _P, _P, _P]
    lib.tfhe_ntt_forward.restype = _I
    lib.tfhe_ntt_inverse.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P]
    lib.tfhe_ntt_inverse.restype = _I
    return lib


def _bitrev(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _as_i32(vals, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(vals, dtype=np.uint64).astype(np.uint32).view(np.int32)).to(device)


def garner_consts_shoup(engine) -> torch.Tensor:
    """(64,) int32 u32 constants of garner_u32 (layout in
    csrc/ntt_device.cuh) and, at [52 + q] and [56 + q], the per-prime
    floor(2^32 / p_q) and the Shoup companion of 2^32 mod p_q that every
    kernel's `%`-free reductions use; built once per engine."""
    gs = getattr(engine, "_garner_consts_shoup", None)
    if gs is None:
        g = engine.garner
        # each partial sum t * p_j + v_j must stay below 2 p_q (j < q)
        if list(g.primes) != sorted(set(g.primes)) or len(g.primes) > 4:
            raise ValueError(f"garner_u32 needs at most 4 ascending primes, got {g.primes}")
        vals = [0] * 64
        for i, p in enumerate(g.primes):
            vals[i] = p
            vals[44 + i] = g.h[i]
            vals[52 + i], vals[56 + i] = 2**32 // p, (2**32 % p << 32) // p
            if i:
                vals[4 + i], vals[8 + i] = g.inv[i]
                for j in range(i):
                    vals[12 + 4 * i + j], vals[28 + 4 * i + j] = g.pmod[i][j]
        prod = g.prod % 2**64
        vals[48], vals[49] = prod & MASK32, prod >> 32
        gs = _as_i32(vals, engine.device)
        engine._garner_consts_shoup = gs
    return gs


def psi_powers(engine) -> torch.Tensor:
    """(P, 2, 2N) int32, built once per engine: psi^t mod p for t in
    [0, 2N) and their Shoup companions. Folded slot h holds evaluation
    j = (h mod R) * C + h / R, at the root psi^(2j+1), so the rotation
    kernels read NTT(X^e) at h as psi^((2j+1) e mod 2N), for e in [N, 2N)
    too (psi^N = -1)."""
    tab = getattr(engine, "_psi_powers", None)
    if tab is None:
        two_n = 2 * engine.n
        rows = np.empty((engine.n_primes, 2, two_n), dtype=np.uint64)
        for i, ntt in enumerate(engine.ntts):
            pw = np.empty(two_n, dtype=np.uint64)
            v = 1
            for t in range(two_n):
                pw[t] = v
                v = v * ntt.psi % ntt.p
            rows[i, 0], rows[i, 1] = pw, (pw << np.uint64(32)) // np.uint64(ntt.p)
        tab = _as_i32(rows, engine.device)
        engine._psi_powers = tab
    return tab


def kernel_tables(engine):
    """(tw, pp) on the engine's device, built once per engine:
    tw (P, 4, N) int32 = psi^bitrev(m), Shoup, psi^-bitrev(m), Shoup;
    pp (P, 4) int32 = p, N^-1 mod p, Shoup, 0 (csrc/ntt_device.cuh)."""
    tabs = getattr(engine, "_kernel_tables", None)
    if tabs is None:
        n = engine.n
        rev = _bitrev(n)
        tw = np.empty((engine.n_primes, 4, n), dtype=np.uint64)
        pp = np.zeros((engine.n_primes, 4), dtype=np.uint64)
        for i, ntt in enumerate(engine.ntts):
            p, psi = ntt.p, ntt.psi
            ipsi = pow(psi, p - 2, p)
            fw = np.array([pow(psi, int(e), p) for e in rev], dtype=np.uint64)
            iw = np.array([pow(ipsi, int(e), p) for e in rev], dtype=np.uint64)
            tw[i, 0], tw[i, 1] = fw, (fw << np.uint64(32)) // np.uint64(p)
            tw[i, 2], tw[i, 3] = iw, (iw << np.uint64(32)) // np.uint64(p)
            ninv = pow(n, p - 2, p)
            pp[i, :3] = (p, ninv, (ninv << 32) // p)
        tabs = (_as_i32(tw, engine.device), _as_i32(pp, engine.device))
        engine._kernel_tables = tabs
    return tabs


def _dims(engine):
    logn = engine.n.bit_length() - 1
    logc = engine.ntts[0].c_dim.bit_length() - 1
    return logn, logc


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous at a 16-byte aligned address: K1 and K2 move 16 bytes a
    thread."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _require_kernel_n(engine, what: str):
    """K1 and K2 are built for N = 256 .. 4096 (csrc/ntt.cu, shape_ok)."""
    if not 256 <= engine.n <= 4096:
        raise ValueError(f"{what} takes N in [256, 4096], got N = {engine.n}")


def check_rows(rows: int, n_primes: int, what: str):
    """K1 and K2 launch one block per (row pair, prime) in a 1-D grid and
    take `rows` as an int: both must stay below 2^31 (the element offsets
    inside the kernels are size_t, so the tensors may exceed 2^31 words)."""
    if rows > 2**31 - 1 or n_primes * ((rows + 1) // 2) > 2**31 - 1:
        raise ValueError(f"{what}: {rows} rows x {n_primes} primes exceed the kernel's 2^31 - 1 grid")


def _require_cuda(x: torch.Tensor, what: str):
    if not x.is_cuda:
        raise ValueError(f"{what} launches a CUDA kernel and needs a CUDA tensor, got {x.device}")


def forward(engine, x: torch.Tensor, small: bool) -> torch.Tensor:
    """K1. small=True: (..., N) ints with |x| < 2^31, taken as int32 (the
    forward_small / nb=3 and nb=4 contracts); small=False: (..., N) int64
    u64 torus values (forward_u64). Returns (..., P, N) int32 residues."""
    _require_kernel_n(engine, "ntt_cuda.forward")
    _require_cuda(x, "ntt_cuda.forward")
    n, n_pr = engine.n, engine.n_primes
    if x.shape[-1] != n:
        raise ValueError(f"last dim {x.shape[-1]} != N = {n}")
    batch = x.shape[:-1]
    # |x| < 2^31 by contract, so the cast to int32 is exact (one op, none
    # for an int32 tensor)
    xf = _aligned(x.to(torch.int32 if small else torch.int64).reshape(-1, n))
    rows = xf.shape[0]
    check_rows(rows, n_pr, "ntt_cuda.forward")
    out = torch.empty((rows, n_pr, n), dtype=torch.int32, device=x.device)
    if rows:
        tw, _ = kernel_tables(engine)
        gs = garner_consts_shoup(engine)
        logn, logc = _dims(engine)
        _build.check(
            _lib().tfhe_ntt_forward(
                xf.data_ptr(), 0 if small else 1, out.data_ptr(), rows, logn, logc, n_pr,
                tw.data_ptr(), gs.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
            ),
            "tfhe_ntt_forward",
        )
        forward.launches += 1
    return out.reshape(*batch, n_pr, n)


forward.launches = 0


def inverse(engine, f: torch.Tensor) -> torch.Tensor:
    """K2: (..., P, N) residues < 2^31 (lazy), folded layout ->
    (..., P, N) int32 canonical residues, natural coefficient order."""
    _require_kernel_n(engine, "ntt_cuda.inverse")
    _require_cuda(f, "ntt_cuda.inverse")
    n, n_pr = engine.n, engine.n_primes
    if tuple(f.shape[-2:]) != (n_pr, n):
        raise ValueError(f"trailing dims {tuple(f.shape[-2:])} != (P, N) = {(n_pr, n)}")
    batch = f.shape[:-2]
    ff = _aligned(f.to(torch.int32).reshape(-1, n_pr, n))
    rows = ff.shape[0]
    check_rows(rows, n_pr, "ntt_cuda.inverse")
    out = torch.empty_like(ff)
    if rows:
        tw, pp = kernel_tables(engine)
        gs = garner_consts_shoup(engine)
        logn, logc = _dims(engine)
        _build.check(
            _lib().tfhe_ntt_inverse(
                ff.data_ptr(), out.data_ptr(), rows, logn, logc, n_pr, tw.data_ptr(),
                pp.data_ptr(), gs.data_ptr(), torch.cuda.current_stream(f.device).cuda_stream,
            ),
            "tfhe_ntt_inverse",
        )
        inverse.launches += 1
    return out.reshape(*batch, n_pr, n)


inverse.launches = 0
