"""Kernel K3, the fused rotation-free CMux steps (csrc/blind_rotate.cu),
and its plain PyTorch version.

Replaces tfhe_tpu/ops/pallas_blind_rotate.py make_pallas_blind_rotate
(pallas_call at pallas_blind_rotate.py:279; `_one_step`, the Garner of
`make_garner_pair`). Each step computes, for level-1 gadget and k = 1,

    acc += (X^{a_j} - 1) * EP(BSK_j, acc)

with (X^{a_j} - 1) applied as a pointwise Shoup multiply by NTT(X^{a_j} - 1).
`cmux_steps` launches the kernel, all steps in one launch of one block per
(ciphertext, prime) in clusters of P blocks, on CUDA tensors and runs
`cmux_steps_plain` on CPU tensors; the plain version follows the JAX
kernel step by step, reading the rows of the monomial table
(`monomial_ntt_table`), and is bit-exact with it. The kernel forms those
rows from powers of psi (`ntt_cuda.psi_powers`) and reconstructs with
`garner_u32` (`ntt_cuda.garner_consts_shoup`); it does not read
`rot_table`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tfhe_tpu_torch import _build, _u64
from tfhe_tpu_torch._u64 import MASK32, condsub, shoup_mulmod
from tfhe_tpu_torch.ops import ntt_cuda

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("blind_rotate")
    lib.tfhe_cmux_steps.argtypes = [_P] * 8 + [_I] * 7 + [_P]
    lib.tfhe_cmux_steps.restype = _I
    lib.tfhe_cmux_max_active_clusters.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
    lib.tfhe_cmux_max_active_clusters.restype = _I
    return lib


def max_active_clusters(engine) -> int:
    """How many clusters of P K3 blocks the card holds at once at the
    engine's N (cudaOccupancyMaxActiveClusters), asked once per engine
    before its first launch. Raises when it is 0: such a cluster cannot be
    scheduled, and no launch falls back to the plain version."""
    clusters = getattr(engine, "_k3_clusters", None)
    if clusters is None:
        logn, logc = ntt_cuda._dims(engine)
        out = _I(0)
        _build.check(
            _lib().tfhe_cmux_max_active_clusters(logn, logc, engine.n_primes, ctypes.byref(out)),
            "tfhe_cmux_max_active_clusters",
        )
        if out.value == 0:
            raise RuntimeError(f"K3: no cluster of {engine.n_primes} blocks fits on the card at N = {engine.n}")
        clusters = engine._k3_clusters = out.value
    return clusters


def monomial_ntt_table(engine) -> torch.Tensor:
    """(2N, P, 2, N) int32: Shoup pairs of NTT(X^e - 1) for e in [0, 2N).
    X^{N+j} = -X^j; e = 0 gives the zero polynomial (a CMux no-op)."""
    n = engine.n
    polys = np.zeros((2 * n, n), dtype=np.int64)
    e = np.arange(2 * n)
    polys[e[:n], e[:n]] += 1
    polys[e[n:], e[n:] - n] -= 1
    polys[:, 0] -= 1
    f = engine.forward_small(torch.from_numpy(polys).to(engine.device))
    return engine.make_shoup(f)


def bsk_to_step_layout(bsk_ntt: torch.Tensor):
    """(n, D=2, k+1=2, P, 2, N) -> per-step (n, 4P, N) value and Shoup
    arrays, rows ordered (prime, d, c)."""
    v = bsk_ntt[..., 0, :]
    s = bsk_ntt[..., 1, :]
    rows = 4 * bsk_ntt.shape[-3]
    v = v.permute(0, 3, 1, 2, 4).reshape(bsk_ntt.shape[0], rows, -1)
    s = s.permute(0, 3, 1, 2, 4).reshape(bsk_ntt.shape[0], rows, -1)
    return v, s


def _check_args(acc, exps, bsk_ntt, rot_table, engine, base_log):
    n, n_pr = engine.n, engine.n_primes
    if not 1 <= base_log <= 31:
        raise ValueError(f"fused CMux needs 1 <= base_log <= 31, got {base_log}")
    if acc.dtype != torch.int64 or acc.dim() != 3 or tuple(acc.shape[1:]) != (2, n):
        raise ValueError(f"acc must be (B, 2, N={n}) int64, got {tuple(acc.shape)} {acc.dtype}")
    steps, b = exps.shape
    if b != acc.shape[0]:
        raise ValueError("exps must be (steps, B)")
    if tuple(bsk_ntt.shape) != (steps, 2, 2, n_pr, 2, n) or bsk_ntt.dtype != torch.int32:
        raise ValueError(f"bsk_ntt must be ({steps}, 2, 2, {n_pr}, 2, {n}) int32")
    if tuple(rot_table.shape) != (2 * n, n_pr, 2, n) or rot_table.dtype != torch.int32:
        raise ValueError(f"rot_table must be ({2 * n}, {n_pr}, 2, {n}) int32")


def cmux_steps(acc, exps, bsk_ntt, rot_table, engine, base_log: int, shift: int) -> torch.Tensor:
    """K3. acc (B, 2, N) int64 GLWE accumulators; exps (steps, B) ints in
    [0, 2N), the mod-switched mask of step j; bsk_ntt (steps, 2, 2, P, 2, N)
    int32, the GGSWs of those steps; rot_table (2N, P, 2, N) int32 from
    monomial_ntt_table, checked and read by the plain version only.
    Returns the accumulators after the `steps` CMux steps."""
    _check_args(acc, exps, bsk_ntt, rot_table, engine, base_log)
    if not acc.is_cuda:
        return cmux_steps_plain(acc, exps, bsk_ntt, rot_table, engine, base_log, shift)
    steps, b = exps.shape
    acc = acc.contiguous()
    e = exps.to(torch.int32).contiguous()
    bsk_ntt = bsk_ntt.contiguous()
    out = torch.empty_like(acc)
    if b == 0 or steps == 0:
        out.copy_(acc)
        return out
    max_active_clusters(engine)
    tw, pp = ntt_cuda.kernel_tables(engine)
    gs = ntt_cuda.garner_consts_shoup(engine)
    logn, logc = ntt_cuda._dims(engine)
    _build.check(
        _lib().tfhe_cmux_steps(
            acc.data_ptr(), out.data_ptr(), e.data_ptr(), bsk_ntt.data_ptr(),
            ntt_cuda.psi_powers(engine).data_ptr(), tw.data_ptr(), pp.data_ptr(), gs.data_ptr(),
            b, steps, logn, logc, engine.n_primes, base_log, shift,
            torch.cuda.current_stream(acc.device).cuda_stream,
        ),
        "tfhe_cmux_steps",
    )
    cmux_steps.launches += 1
    return out


cmux_steps.launches = 0


def level1_digits_forward_plain(acc, engine, base_log: int) -> torch.Tensor:
    """Level-1 gadget digits of the accumulator rows, forward-transformed:
    acc (B, 2, N) int64 -> (B, 2, P, N) u32 residues on int64 lanes, as
    the JAX kernels compute them on the hi plane: state =
    (x + 2^(63-B)) >> (64-B), balanced to [-2^(B-1), 2^(B-1))."""
    hi = _u64.srl(acc, 32)
    dh2 = (hi + (1 << (64 - base_log - 1 - 32))) & MASK32
    state = dh2 >> (64 - base_log - 32)
    d = state - torch.where(state >= (1 << (base_log - 1)), 1 << base_log, 0)
    return _u64.u32(engine.forward_small_plain(d))


def one_step_plain(acc, rv, rs, bv, bs, engine, base_log: int, shift: int) -> torch.Tensor:
    """One CMux step, the JAX `_one_step` in PyTorch. acc (B, 2, N) int64;
    rv/rs (B, P, N) the gathered NTT(X^a - 1) rows and Shoup companions;
    bv/bs (4P, N) BSK rows ordered (prime, d, c)."""
    fd = level1_digits_forward_plain(acc, engine, base_log)  # (B, 2, P, N)
    bv, bs = _u64.u32(bv), _u64.u32(bs)
    rv, rs = _u64.u32(rv), _u64.u32(rs)
    res = []
    for i, ntt in enumerate(engine.ntts):
        p = ntt.p
        outs = []
        for c in range(2):
            t0 = shoup_mulmod(fd[:, 0, i], bv[4 * i + c], bs[4 * i + c], p)
            t1 = shoup_mulmod(fd[:, 1, i], bv[4 * i + 2 + c], bs[4 * i + 2 + c], p)
            s = condsub(t0 + t1, 2 * p)  # EP in the NTT domain
            s = shoup_mulmod(s, rv[:, i], rs[:, i], p)  # (X^a - 1) multiply
            outs.append(condsub(condsub(s, 2 * p), p))
        res.append(ntt.inverse(torch.stack(outs, dim=1)))  # (B, 2, N) canonical
    x = engine.crt_reconstruct(res)
    return acc + (x << shift if shift else x)


def cmux_steps_plain(acc, exps, bsk_ntt, rot_table, engine, base_log: int, shift: int) -> torch.Tensor:
    """Plain version of K3 on any device: the same function of the same
    inputs, step by step."""
    _check_args(acc, exps, bsk_ntt, rot_table, engine, base_log)
    bv_all, bs_all = bsk_to_step_layout(bsk_ntt)
    exps = exps.to(torch.int64)
    for j in range(exps.shape[0]):
        rows = rot_table[exps[j]]  # (B, P, 2, N)
        acc = one_step_plain(
            acc, rows[..., 0, :], rows[..., 1, :], bv_all[j], bs_all[j], engine, base_log, shift
        )
    return acc
