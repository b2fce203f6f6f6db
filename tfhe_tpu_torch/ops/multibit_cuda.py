"""Kernel K4, the multi-bit blind-rotation group steps (csrc/multibit.cu),
and its plain PyTorch version.

Replaces tfhe_tpu/ops/pallas_multibit.py make_pallas_multibit_step
(pallas_call at pallas_multibit.py:184; `_one_step`, `_horner`, the Garner
of `make_garner_pair`) and its caller multibit_rotate_fused / _scan_rotate,
which launch the kernel once per group inside lax.scan. Each group step
computes, for level-1 gadget and k = 1,

    acc <- EP( sum_v (prod_{i in v} m_i) . BSK_{j,v} , acc )

with m_i the NTT(X^{a_i}) rows of the group's g mask exponents, the 2^g
aggregation Horner-factored over the bits. The result replaces the
accumulator. `group_steps` launches the kernel, all groups in one launch
of one block per (ciphertext, prime) in clusters of P blocks, on CUDA
tensors and runs `group_steps_plain` on CPU tensors; the plain version
follows the JAX kernel step by step and is bit-exact with it. The kernel
reads the monomial rows as powers of psi (`psi_powers`) and reconstructs
with `garner_u32` (`garner_consts_shoup`); it does not read `table`,
which the plain version and the loop form of core/multibit do.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tfhe_tpu_torch import _build, _u64
from tfhe_tpu_torch._u64 import MASK32, condsub, shoup_mulmod
from tfhe_tpu_torch.ops import ntt_cuda
from tfhe_tpu_torch.ops.blind_rotate_cuda import level1_digits_forward_plain

_P = ctypes.c_void_p
_I = ctypes.c_int

GROUP_SIZES = (2, 3, 4)


def _lib():
    lib = _build.load("multibit")
    lib.tfhe_multibit_group_steps.argtypes = [_P] * 8 + [_I] * 8 + [_P]
    lib.tfhe_multibit_group_steps.restype = _I
    return lib


def _as_i32(vals, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(vals, dtype=np.uint64).astype(np.uint32).view(np.int32)).to(device)


def garner_consts_shoup(engine) -> torch.Tensor:
    """(64,) int32 u32 constants of garner_u32 (layout in
    csrc/ntt_device.cuh) and, at [52 + q] and [56 + q], K4's per-prime
    floor(2^32 / p_q) and the Shoup companion of 2^32 mod p_q; built once
    per engine."""
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
    j = (h mod R) * C + h / R, at the root psi^(2j+1), so the kernel reads
    NTT(X^e) at h as psi^((2j+1) e mod 2N), for e in [N, 2N) too (psi^N = -1)."""
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


def multibit_bsk_to_step_layout(bsk_ntt: torch.Tensor):
    """(G, V, D=2, k+1=2, P, 2, N) -> per-group (G, V*4P, N) value and
    Shoup arrays, rows ordered (v, prime, d, c)."""
    v = bsk_ntt[..., 0, :]  # (G, V, 2, 2, P, N)
    s = bsk_ntt[..., 1, :]
    gdim, vdim = v.shape[0], v.shape[1]
    rows = vdim * 4 * bsk_ntt.shape[-3]
    v = v.permute(0, 1, 4, 2, 3, 5).reshape(gdim, rows, -1)
    s = s.permute(0, 1, 4, 2, 3, 5).reshape(gdim, rows, -1)
    return v, s


def _check_args(acc, a, bsk_ntt, table, engine, base_log, group_size):
    n, n_pr = engine.n, engine.n_primes
    g = group_size
    if g not in GROUP_SIZES:
        raise ValueError(f"group size must be one of {GROUP_SIZES}, got {g}")
    if not 1 <= base_log <= 31:
        raise ValueError(f"fused group step needs 1 <= base_log <= 31, got {base_log}")
    if acc.dtype != torch.int64 or acc.dim() != 3 or tuple(acc.shape[1:]) != (2, n):
        raise ValueError(f"acc must be (B, 2, N={n}) int64, got {tuple(acc.shape)} {acc.dtype}")
    if a.dim() != 2 or a.shape[1] != acc.shape[0] or a.shape[0] % g:
        raise ValueError(f"a must be (groups * {g}, B), got {tuple(a.shape)}")
    groups = a.shape[0] // g
    if tuple(bsk_ntt.shape) != (groups, 1 << g, 2, 2, n_pr, 2, n) or bsk_ntt.dtype != torch.int32:
        raise ValueError(f"bsk_ntt must be ({groups}, {1 << g}, 2, 2, {n_pr}, 2, {n}) int32")
    if tuple(table.shape) != (2 * n, n_pr, 2, n) or table.dtype != torch.int32:
        raise ValueError(f"table must be ({2 * n}, {n_pr}, 2, {n}) int32")


def group_steps(acc, a, bsk_ntt, table, engine, base_log: int, shift: int, group_size: int) -> torch.Tensor:
    """K4. acc (B, 2, N) int64 GLWE accumulators; a (n, B) ints in [0, 2N),
    the mod-switched mask, n = groups * g; bsk_ntt (groups, 2^g, 2, 2, P, 2, N)
    int32, the pattern GGSWs of those groups; table (2N, P, 2, N) int32,
    the Shoup rows of NTT(X^e) (core.multibit.monomial_x_table), checked
    and read by the plain version only. Returns the accumulators after all
    group steps."""
    _check_args(acc, a, bsk_ntt, table, engine, base_log, group_size)
    if not acc.is_cuda:
        return group_steps_plain(acc, a, bsk_ntt, table, engine, base_log, shift, group_size)
    b = acc.shape[0]
    groups = a.shape[0] // group_size
    acc = acc.contiguous()
    a = a.to(torch.int32).contiguous()
    bsk_ntt = bsk_ntt.contiguous()
    out = torch.empty_like(acc)
    if b == 0 or groups == 0:
        out.copy_(acc)
        return out
    tw, pp = ntt_cuda.kernel_tables(engine)
    gs = garner_consts_shoup(engine)
    logn, logc = ntt_cuda._dims(engine)
    _build.check(
        _lib().tfhe_multibit_group_steps(
            acc.data_ptr(), out.data_ptr(), a.data_ptr(), bsk_ntt.data_ptr(), psi_powers(engine).data_ptr(),
            tw.data_ptr(), pp.data_ptr(), gs.data_ptr(), b, groups, group_size, logn, logc,
            engine.n_primes, base_log, shift, torch.cuda.current_stream(acc.device).cuda_stream,
        ),
        "tfhe_multibit_group_steps",
    )
    group_steps.launches += 1
    return out


group_steps.launches = 0


def _horner(inners: dict, mv, ms, p: int, bits: tuple):
    """Sum_v (prod_{i in v} m_i) * inner_v over v-subsets of `bits`,
    factored so each multiply is one Shoup product by m_i (the JAX
    `_horner`, lazy residues in [0, 2p))."""
    if not bits:
        return inners[0]
    b = bits[-1]
    lo = _horner({v: x for v, x in inners.items() if not (v >> b) & 1}, mv, ms, p, bits[:-1])
    hi = _horner({v ^ (1 << b): x for v, x in inners.items() if (v >> b) & 1}, mv, ms, p, bits[:-1])
    term = shoup_mulmod(condsub(hi, p), mv[b], ms[b], p)
    return condsub(lo + term, 2 * p)


def one_group_step_plain(acc, mv, ms, bv, bs, engine, base_log: int, shift: int, group_size: int) -> torch.Tensor:
    """One group step, the JAX `_one_step` in PyTorch. acc (B, 2, N) int64;
    mv/ms (g, B, P, N) the gathered NTT(X^{a_i}) rows and Shoup companions;
    bv/bs (V*4P, N) the group's BSK rows ordered (v, prime, d, c). Returns
    the new accumulator (it replaces the old one)."""
    g = group_size
    n_pr = engine.n_primes
    fd = level1_digits_forward_plain(acc, engine, base_log)  # (B, 2, P, N)
    bv, bs = _u64.u32(bv), _u64.u32(bs)
    mv, ms = _u64.u32(mv), _u64.u32(ms)
    res = []
    for i, ntt in enumerate(engine.ntts):
        p = ntt.p
        mvi = [mv[b, :, i] for b in range(g)]
        msi = [ms[b, :, i] for b in range(g)]
        outs = []
        for c in range(2):
            inners = {}
            for v in range(1 << g):
                base = v * 4 * n_pr + 4 * i
                t0 = shoup_mulmod(fd[:, 0, i], bv[base + c], bs[base + c], p)
                t1 = shoup_mulmod(fd[:, 1, i], bv[base + 2 + c], bs[base + 2 + c], p)
                inners[v] = condsub(t0 + t1, 2 * p)
            s = _horner(inners, mvi, msi, p, tuple(range(g)))
            outs.append(condsub(condsub(s, 2 * p), p))
        res.append(ntt.inverse(torch.stack(outs, dim=1)))  # (B, 2, N) canonical
    x = engine.crt_reconstruct(res)
    return x << shift if shift else x


def group_steps_plain(acc, a, bsk_ntt, table, engine, base_log: int, shift: int, group_size: int) -> torch.Tensor:
    """Plain version of K4 on any device: the same function of the same
    inputs, group by group."""
    _check_args(acc, a, bsk_ntt, table, engine, base_log, group_size)
    g = group_size
    bv_all, bs_all = multibit_bsk_to_step_layout(bsk_ntt)
    a = a.to(torch.int64)
    for j in range(a.shape[0] // g):
        rows = table[a[g * j : g * (j + 1)]]  # (g, B, P, 2, N)
        acc = one_group_step_plain(
            acc, rows[..., 0, :], rows[..., 1, :], bv_all[j], bs_all[j], engine, base_log, shift, g
        )
    return acc
