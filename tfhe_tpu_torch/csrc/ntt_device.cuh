// Device functions shared by the NTT kernels (ntt.cu), the fused CMux
// kernel (blind_rotate.cu) and the multi-bit group-step kernel
// (multibit.cu): u32 Shoup arithmetic mod a prime p < 2^30, the bit
// reversal of the folded layout, and the Garner reconstruction garner_u32
// of K3 and K4. The NTT itself, in register rounds on padded rows, is in
// rotate_device.cuh.
//
// Forward: Cooley-Tukey over the bit-reversed powers of psi (the primitive
// 2N-th root), natural order in, bit-reversed order out: slot k holds
// a(psi^(2j+1)) with j = bitrev(k). Inverse: Gentleman-Sande over the
// bit-reversed powers of psi^-1, bit-reversed order in, natural order out,
// then a multiply by N^-1. The engine's *folded layout* puts evaluation j at
// h = (j mod C) * R + j / C (N = R * C), so folded slot h = t R + s holds
// NTT slot bitrev(s C + t); the kernels read and write the folded layout
// directly.
//
// Twiddle tables, per prime, 4 rows of N u32: psi_rev, its Shoup companions,
// psi_inv_rev, its Shoup companions. Prime params, per prime, 4 u32:
// p, N^-1 mod p, its Shoup companion, 0.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tfhe {

__device__ __forceinline__ uint32_t mul_shoup(uint32_t a, uint32_t w, uint32_t ws, uint32_t p) {
  // a * w mod p for any u32 a and w < p, ws = floor(w * 2^32 / p); canonical.
  uint32_t q = __umulhi(a, ws);
  uint32_t r = a * w - q * p;  // in [0, 2p)
  return r >= p ? r - p : r;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  uint32_t s = a + b;
  return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t p) {
  return a >= b ? a - b : a + p - b;
}

// The NTT slot of evaluation j: slot k holds evaluation bitrev(k), and
// folded slot h = t R + s holds evaluation s C + t.
__device__ __forceinline__ int bitrev(int j, int logn) {
  return (int)(__brev((unsigned)j) >> (32 - logn));
}

// Garner in u32 Shoup arithmetic: the canonical residues r[q], q <
// nprimes <= 4, of one coefficient -> the signed CRT value mod 2^64. The
// mixed-radix digits of a canonical residue tuple are unique, so the result
// equals crt_reconstruct's. The digits come from mul_shoup by precomputed
// companions, with no 64-bit `%`; then the wrapping u64 Horner and a
// lexicographic compare with the digits of prod/2 for the negative range
// (values above prod/2 are prod below their signed value). The primes ascend
// (checked where the constants are built), so t * p_j + v_j < 2 p_q and one
// conditional subtract keeps each partial sum canonical.
//
// Constants gs (u32, ops/ntt_cuda.garner_consts_shoup): [0..3] primes,
// [4..7] inv[q], [8..11] their Shoup companions, [12..27] pmod[q][j] at
// 12 + 4 q + j, [28..43] their companions at 28 + 4 q + j, [44..47] the
// mixed-radix digits of prod/2, [48], [49] prod mod 2^64 (low, high word);
// the rotation kernels keep per-prime constants at [52..59] of the same
// array.
constexpr int kGarnerShoupWords = 64;

__device__ __forceinline__ uint64_t garner_u32(const uint32_t (&r)[4], int nprimes,
                                               const uint32_t* gs) {
  uint32_t v[4] = {r[0], 0, 0, 0};
#pragma unroll
  for (int q = 1; q < 4; ++q) {
    if (q < nprimes) {
      const uint32_t pq = gs[q];
      uint32_t t = v[q - 1];
#pragma unroll
      for (int j = q - 2; j >= 0; --j) {
        t = mul_shoup(t, gs[12 + 4 * q + j], gs[28 + 4 * q + j], pq) + v[j];
        t = t >= pq ? t - pq : t;
      }
      v[q] = mul_shoup(sub_mod(r[q], t, pq), gs[4 + q], gs[8 + q], pq);
    }
  }
  uint64_t x = 0;
  bool neg = false, eq = true;
#pragma unroll
  for (int j = 3; j >= 0; --j) {
    if (j < nprimes) {
      x = v[j] + (uint64_t)gs[j] * x;
      neg = neg || (eq && v[j] > gs[44 + j]);
      eq = eq && v[j] == gs[44 + j];
    }
  }
  return neg ? x - (((uint64_t)gs[49] << 32) | gs[48]) : x;
}

}  // namespace tfhe
