// Device functions shared by the NTT kernels (ntt.cu), the fused CMux
// kernel (blind_rotate.cu) and the multi-bit group-step kernel
// (multibit.cu): u32 Shoup arithmetic mod a prime p < 2^30, in-shared-memory
// negacyclic NTTs of one block, and the Garner reconstructions (garner_u64
// for K3, garner_u32 for K4).
//
// Forward: Cooley-Tukey over the bit-reversed powers of psi (the primitive
// 2N-th root), natural order in, bit-reversed order out: slot k holds
// a(psi^(2j+1)) with j = bitrev(k). Inverse: Gentleman-Sande over the
// bit-reversed powers of psi^-1, bit-reversed order in, natural order out,
// then a multiply by N^-1. The engine's *folded layout* puts evaluation j at
// h = (j mod C) * R + j / C (N = R * C); `folded_slot` maps k to that h, so
// the kernels read and write the folded layout directly.
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

__device__ __forceinline__ int folded_slot(int k, int logn, int logc) {
  int j = (int)(__brev((unsigned)k) >> (32 - logn));
  return ((j & ((1 << logc) - 1)) << (logn - logc)) + (j >> logc);
}

// The NTT slot of evaluation j. Folded slot h = t R + s holds evaluation
// j = s C + t, so folded_slot(bitrev(s C + t)) == h.
__device__ __forceinline__ int bitrev(int j, int logn) {
  return (int)(__brev((unsigned)j) >> (32 - logn));
}

// Forward NTT of `rows` consecutive length-n rows in shared memory, all
// values canonical. Every thread of the block must call it; it ends with a
// barrier. The caller puts a barrier between filling buf and the call.
__device__ void ntt_fwd_rows(uint32_t* buf, int rows, int logn, const uint32_t* psi,
                             const uint32_t* psi_s, uint32_t p) {
  const int n = 1 << logn;
  const int half = n >> 1;
  const int total = rows * half;
  for (int m = 1, logt = logn - 1; m < n; m <<= 1, --logt) {
    const int t = 1 << logt;
    for (int b = threadIdx.x; b < total; b += blockDim.x) {
      uint32_t* a = buf + (b >> (logn - 1)) * n;
      const int bb = b & (half - 1);
      const int i = bb >> logt;
      const int j = (i << (logt + 1)) + (bb & (t - 1));
      const uint32_t u = a[j];
      const uint32_t v = mul_shoup(a[j + t], psi[m + i], psi_s[m + i], p);
      a[j] = add_mod(u, v, p);
      a[j + t] = sub_mod(u, v, p);
    }
    __syncthreads();
  }
}

// Inverse NTT of `rows` consecutive rows, bit-reversed order in, natural out,
// scaled by N^-1. Same calling rules as ntt_fwd_rows.
__device__ void ntt_inv_rows(uint32_t* buf, int rows, int logn, const uint32_t* ipsi,
                             const uint32_t* ipsi_s, uint32_t p, uint32_t ninv,
                             uint32_t ninv_s) {
  const int n = 1 << logn;
  const int half = n >> 1;
  const int total = rows * half;
  for (int m = n, logt = 0; m > 1; m >>= 1, ++logt) {
    const int t = 1 << logt;
    const int h = m >> 1;
    for (int b = threadIdx.x; b < total; b += blockDim.x) {
      uint32_t* a = buf + (b >> (logn - 1)) * n;
      const int bb = b & (half - 1);
      const int i = bb >> logt;
      const int j = (i << (logt + 1)) + (bb & (t - 1));
      const uint32_t u = a[j];
      const uint32_t v = a[j + t];
      a[j] = add_mod(u, v, p);
      a[j + t] = mul_shoup(sub_mod(u, v, p), ipsi[h + i], ipsi_s[h + i], p);
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < rows * n; idx += blockDim.x) {
    buf[idx] = mul_shoup(buf[idx], ninv, ninv_s, p);
  }
  __syncthreads();
}

// Garner: the canonical residues of one coefficient, res[q * stride] for
// prime q < nprimes, -> the signed CRT value mod 2^64, in native u64
// arithmetic (mixed-radix digits, Horner, then a lexicographic compare of
// the digits with those of prod/2 for the negative range). Called by K3
// (blind_rotate.cu) on its residue rows.
//
// Constants gc (u64): [0..3] primes, [4..7] inv[i], [8..23] pmod[i][j] at
// 8 + 4 i + j, [24..27] mixed-radix digits of prod/2, [28] prod mod 2^64
// (ops/blind_rotate_cuda.garner_consts).
__device__ __forceinline__ uint64_t garner_u64(const uint32_t* res, size_t stride, int nprimes,
                                               const uint64_t* __restrict__ gc) {
  uint64_t v[4];
  v[0] = res[0];
  for (int q = 1; q < nprimes; ++q) {
    const uint64_t pq = gc[q];
    uint64_t tq = v[q - 1];
    for (int j = q - 2; j >= 0; --j) {
      tq = (tq * gc[8 + 4 * q + j] + v[j]) % pq;
    }
    const uint64_t rq = res[(size_t)q * stride];
    const uint64_t d = (rq + pq - tq % pq) % pq;
    v[q] = d * gc[4 + q] % pq;
  }
  uint64_t x = v[nprimes - 1];
  for (int j = nprimes - 2; j >= 0; --j) x = v[j] + gc[j] * x;
  bool neg = v[nprimes - 1] > gc[24 + nprimes - 1];
  bool eq = v[nprimes - 1] == gc[24 + nprimes - 1];
  for (int j = nprimes - 2; j >= 0; --j) {
    neg = neg || (eq && v[j] > gc[24 + j]);
    eq = eq && v[j] == gc[24 + j];
  }
  return neg ? x - gc[28] : x;
}

// Garner in u32 Shoup arithmetic (K4): the canonical residues r[q], q <
// nprimes <= 4, of one coefficient -> the signed CRT value mod 2^64. The
// mixed-radix digits of a canonical residue tuple are unique, so the result
// equals garner_u64's. The digits come from mul_shoup by precomputed
// companions, with no 64-bit `%`; then the wrapping u64 Horner and the same
// lexicographic compare with the digits of prod/2. The primes ascend
// (checked where the constants are built), so t * p_j + v_j < 2 p_q and one
// conditional subtract keeps each partial sum canonical.
//
// Constants gs (u32, ops/multibit_cuda.garner_consts_shoup): [0..3] primes,
// [4..7] inv[q], [8..11] their Shoup companions, [12..27] pmod[q][j] at
// 12 + 4 q + j, [28..43] their companions at 28 + 4 q + j, [44..47] the
// mixed-radix digits of prod/2, [48], [49] prod mod 2^64 (low, high word);
// K4 keeps per-prime constants at [52..59] of the same array.
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

__host__ __device__ inline int ntt_threads(int work) {
  // one thread per butterfly up to 512 threads, at least one warp
  int t = work < 512 ? work : 512;
  return t < 32 ? 32 : t;
}

}  // namespace tfhe
