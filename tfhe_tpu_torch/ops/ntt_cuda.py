"""Wrappers of kernels K1 (forward NTT) and K2 (inverse NTT), csrc/ntt.cu.

K1 replaces tfhe_tpu/ops/pallas_ntt.py make_pallas_ntt `forward`
(pallas_call at pallas_ntt.py:494); K2 its `inverse` (pallas_ntt.py:518).
Their plain PyTorch versions are FoldedCrtEngine.forward_small_plain /
forward_i32_plain / forward_u64_plain and inverse_plain
(ops/folded_ntt.py), which mirror the JAX transforms. The wrappers take
CUDA tensors only: on anything else they raise. Each counts its launches
in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tfhe_tpu_torch import _build, _u64

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("ntt")
    lib.tfhe_ntt_forward.argtypes = [_P, _I, _P, _I, _I, _I, _I, _P, _P, _P]
    lib.tfhe_ntt_forward.restype = _I
    lib.tfhe_ntt_inverse.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P]
    lib.tfhe_ntt_inverse.restype = _I
    return lib


def _bitrev(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


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
        as_i32 = lambda a: torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(engine.device)
        tabs = (as_i32(tw), as_i32(pp))
        engine._kernel_tables = tabs
    return tabs


def _dims(engine):
    logn = engine.n.bit_length() - 1
    logc = engine.ntts[0].c_dim.bit_length() - 1
    return logn, logc


def _require_cuda(x: torch.Tensor, what: str):
    if not x.is_cuda:
        raise ValueError(f"{what} launches a CUDA kernel and needs a CUDA tensor, got {x.device}")


def forward(engine, x: torch.Tensor, small: bool) -> torch.Tensor:
    """K1. small=True: (..., N) ints with |x| < 2^31, taken as int32 (the
    forward_small / nb=3 and nb=4 contracts); small=False: (..., N) int64
    u64 torus values (forward_u64). Returns (..., P, N) int32 residues."""
    _require_cuda(x, "ntt_cuda.forward")
    n, n_pr = engine.n, engine.n_primes
    if x.shape[-1] != n:
        raise ValueError(f"last dim {x.shape[-1]} != N = {n}")
    batch = x.shape[:-1]
    xf = (_u64.trunc_i32(x).to(torch.int32) if small else x.to(torch.int64)).reshape(-1, n).contiguous()
    rows = xf.shape[0]
    out = torch.empty((rows, n_pr, n), dtype=torch.int32, device=x.device)
    if rows:
        tw, pp = kernel_tables(engine)
        logn, logc = _dims(engine)
        _build.check(
            _lib().tfhe_ntt_forward(
                xf.data_ptr(), 0 if small else 1, out.data_ptr(), rows, logn, logc, n_pr,
                tw.data_ptr(), pp.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
            ),
            "tfhe_ntt_forward",
        )
        forward.launches += 1
    return out.reshape(*batch, n_pr, n)


forward.launches = 0


def inverse(engine, f: torch.Tensor) -> torch.Tensor:
    """K2: (..., P, N) residues < 2^31 (lazy), folded layout ->
    (..., P, N) int32 canonical residues, natural coefficient order."""
    _require_cuda(f, "ntt_cuda.inverse")
    n, n_pr = engine.n, engine.n_primes
    if tuple(f.shape[-2:]) != (n_pr, n):
        raise ValueError(f"trailing dims {tuple(f.shape[-2:])} != (P, N) = {(n_pr, n)}")
    batch = f.shape[:-2]
    ff = f.to(torch.int32).reshape(-1, n_pr, n).contiguous()
    rows = ff.shape[0]
    out = torch.empty_like(ff)
    if rows:
        tw, pp = kernel_tables(engine)
        logn, logc = _dims(engine)
        _build.check(
            _lib().tfhe_ntt_inverse(
                ff.data_ptr(), out.data_ptr(), rows, logn, logc, n_pr, tw.data_ptr(),
                pp.data_ptr(), torch.cuda.current_stream(f.device).cuda_stream,
            ),
            "tfhe_ntt_inverse",
        )
        inverse.launches += 1
    return out.reshape(*batch, n_pr, n)


inverse.launches = 0
