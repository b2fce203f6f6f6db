"""Frozen operation and byte counts of the rotation kernels and of the
GLWE matmul, and the card's peaks. A kernel's roofline share is the least
time the card could take for the work its inputs need, over the time the
trace gives the kernel.

Peaks (NVIDIA H100 SXM5 data sheet, dense, at the 700 W power limit):
- HBM3 bandwidth 3.35e12 bytes/s;
- 67e12 FP32 operations/s outside the tensor cores, used as the peak of
  32-bit integer instructions. NVIDIA publishes no INT32 rate; its H100
  architecture whitepaper gives a Hopper SM 64 INT32 lanes against 128
  FP32 lanes, so the true integer peak is at most this one and the shares
  below can read up to 2x low, never high.

Operations are 32-bit integer instructions counted from the kernels'
arithmetic: a butterfly is a Shoup multiply (mul.hi, two mul.lo, sub,
compare-select) plus an add-mod and a sub-mod; the Garner reconstruction
costs OPS_GARNER per output coefficient. Bytes count each input read once
and each output written once: the accumulators in and out, the mask
exponents, and the NTT-domain key (value and Shoup companion, 4 bytes
each) read once per launch whatever the batch.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

OPS_BUTTERFLY = 10
OPS_MULMOD = 5
OPS_ADDMOD = 2
OPS_GARNER = 40  # per coefficient: three u64 remainders and the Horner
DECOMPOSE_OPS = 6  # per coefficient and row: the level-1 digit


def bound_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ALU_OPS_PER_S)


def ntt_ops(rows: int, n_pr: int, n: int) -> float:
    return rows * n_pr * ((n // 2) * int(math.log2(n)) * OPS_BUTTERFLY + n * OPS_MULMOD)


def matmul_ops(rows: int, inner: int, out: int, k: int, n_pr: int, n: int, ks_level: int) -> float:
    """The encrypted x clear matmul, enc(rows x inner) x clear(inner x out),
    over P primes at polynomial size N: the forward transforms of the input
    GLWEs; the one-to-many products (a Shoup multiply each) and their sums
    over the inner chunks; the inverse transforms of the masks and their
    Garner; the body's coefficient N-1 (a multiply-add a coefficient and
    prime) and its Garner; the packing keyswitch's digits, their forward
    transforms, the MAC against the key (a multiply and an add), its
    inverse transforms and their Garner; the switch to the output modulus
    (an add and a shift a coefficient)."""
    chunks, out_chunks, n_in = -(-inner // n), -(-out // n), k * n
    lwes = rows * out
    products = lwes * chunks * (k + 1) * n_pr * n * OPS_MULMOD + lwes * (chunks - 1) * (k + 1) * n_pr * n * OPS_ADDMOD
    masks = ntt_ops(lwes * k, n_pr, n) + lwes * k * n * OPS_GARNER
    body = lwes * n_pr * n * OPS_MULMOD + lwes * OPS_GARNER
    digit_rows = rows * out_chunks * n_in * ks_level
    keyswitch = (lwes * n_in * ks_level * DECOMPOSE_OPS + ntt_ops(digit_rows, n_pr, n)
                 + digit_rows * (k + 1) * n_pr * n * (OPS_MULMOD + OPS_ADDMOD)
                 + ntt_ops(rows * out_chunks * (k + 1), n_pr, n) + rows * out_chunks * (k + 1) * n * OPS_GARNER)
    switch = rows * out_chunks * (k + 1) * n * OPS_ADDMOD
    return ntt_ops(rows * chunks * (k + 1), n_pr, n) + products + masks + body + keyswitch + switch


def matmul_bytes(rows: int, inner: int, out: int, k: int, n_pr: int, n: int, ks_level: int) -> int:
    """Each read or written once: the input GLWEs (u64), the prepared
    weights and the packing key in the transform domain (value and Shoup
    companion, 4 bytes each), the stored outputs (4 bytes a coefficient)."""
    chunks, out_chunks = -(-inner // n), -(-out // n)
    inputs = rows * chunks * (k + 1) * n * 8
    weights = out * chunks * n_pr * 2 * n * 4
    key = k * n * ks_level * (k + 1) * n_pr * 2 * n * 4
    return inputs + weights + key + rows * out_chunks * (k + 1) * n * 4


def matmul_bound_s(rows: int, inner: int, out: int, k: int, n_pr: int, n: int, ks_level: int) -> float:
    shape = (rows, inner, out, k, n_pr, n, ks_level)
    return bound_s(matmul_bytes(*shape), matmul_ops(*shape))


def cmux_ops(batch: int, steps: int, n_pr: int, n: int) -> float:
    """K3: per step and ciphertext, per prime the forward and inverse NTT of
    the 2 rows, the digits, the external product (4 multiplies and an add)
    and the (X^a - 1) multiply; the Garner of the 2 output rows."""
    per_prime = 2 * ntt_ops(2, 1, n) + 2 * n * DECOMPOSE_OPS + n * 5 * OPS_MULMOD
    return batch * steps * (n_pr * per_prime + 2 * n * OPS_GARNER)


def group_step_ops(batch: int, groups: int, g: int, n_pr: int, n: int) -> float:
    """K4: as K3, with the 2^g-pattern aggregation of the group's GGSWs."""
    v = 1 << g
    pointwise = 2 * (2 * v * OPS_MULMOD + v * OPS_ADDMOD + (v - 1) * (OPS_MULMOD + OPS_ADDMOD))
    per_prime = 2 * ntt_ops(2, 1, n) + 2 * n * DECOMPOSE_OPS + n * pointwise
    return batch * groups * (n_pr * per_prime + 2 * n * OPS_GARNER)


def rotation_bytes(batch: int, steps: int, exps_per_step: int, key_bytes: int, n: int) -> int:
    """Accumulators (2 rows of N u64) in and out, the int32 exponents and
    the key read once."""
    return 2 * batch * 2 * n * 8 + steps * exps_per_step * batch * 4 + key_bytes


def key_bytes(key_ggsws: int, n_pr: int, n: int) -> int:
    """A level-1, k = 1 GGSW in the NTT domain: 2 rows x 2 components x P
    primes x (value, Shoup) x N words of 4 bytes."""
    return key_ggsws * 2 * 2 * n_pr * 2 * n * 4


def k3_bound_s(batch: int, lwe_dim: int, n_pr: int, n: int) -> float:
    return bound_s(rotation_bytes(batch, lwe_dim, 1, key_bytes(lwe_dim, n_pr, n), n),
                   cmux_ops(batch, lwe_dim, n_pr, n))


def k4_bound_s(batch: int, lwe_dim: int, g: int, n_pr: int, n: int) -> float:
    groups = lwe_dim // g
    return bound_s(rotation_bytes(batch, groups, g, key_bytes(groups << g, n_pr, n), n),
                   group_step_ops(batch, groups, g, n_pr, n))
