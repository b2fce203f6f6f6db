// Device functions of the two rotation kernels, K3 (blind_rotate.cu) and
// K4 (multibit.cu), which share one design: one block per (ciphertext,
// prime) in a cluster of P blocks, the block's two residue rows padded in
// shared memory, the NTT in register rounds of three stages, and the
// level-1 digit reduced mod each prime with no `%`. The NTT kernels K1 and
// K2 (ntt.cu) run the same rounds on two rows of one prime.
#pragma once

#include "ntt_device.cuh"

namespace tfhe {

// Level-1 gadget digit of the torus value x, d = round(x / 2^(64-B))
// balanced to [-2^(B-1), 2^(B-1)), as a canonical residue mod p, with no
// `%`: |d| <= 2^30 is reduced by one Shoup quotient against w = 1
// (ws1 = floor(2^32 / p)), then negated for d < 0. Right for every
// base_log B in 1..31 and every prime p < 2^31.
__device__ __forceinline__ uint32_t digit_residue(uint64_t x, int base_log, uint32_t p,
                                                  uint32_t ws1) {
  const uint32_t state = (uint32_t)((x + (1ull << (63 - base_log))) >> (64 - base_log));
  const bool neg = state >= (1u << (base_log - 1));
  const uint32_t mag = neg ? (uint32_t)((1ull << base_log) - state) : state;
  const uint32_t r = mul_shoup(mag, 1, ws1, p);
  return neg && r ? p - r : r;
}

// The Shoup companion floor(w 2^32 / p) of a canonical w, exactly, in u32:
// with 2^32 = ws1 p + c1 it is w ws1 + floor(w c1 / p), and the second term
// is one Shoup quotient against c1 (companion c1s) plus a correction.
__device__ __forceinline__ uint32_t shoup_companion(uint32_t w, uint32_t p, uint32_t ws1,
                                                    uint32_t c1, uint32_t c1s) {
  const uint32_t q = __umulhi(w, c1s);
  return w * ws1 + q + (w * c1 - q * p >= p ? 1u : 0u);
}

// The kernels' residue rows are padded by one word every 32, so that the strided
// accesses of the NTT rounds and of the pointwise step fall into distinct
// shared-memory banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Unit uu of a round -> its block b and offset o < 2^logs (the unit's element
// stride): offsets vary fastest across a warp when the stride is 32 words or
// more, blocks otherwise, so that a warp's accesses to the padded rows fall
// into distinct banks.
__device__ __forceinline__ void unit_coords(int uu, int logunits, int logs, int& b, int& o) {
  if (logs >= 5) {
    b = uu >> logs;
    o = uu & ((1 << logs) - 1);
  } else {
    const int lognb = logunits - logs;
    b = uu & ((1 << lognb) - 1);
    o = uu >> lognb;
  }
}

// K <= 3 consecutive forward (Cooley-Tukey) stages of both rows in
// registers, one barrier per round: the radix-2 stage with m groups of
// distance t = 2^logt (butterfly (j, j + t) of group i twiddled by
// psi[m + i]) and the K - 1 after it. A unit is the 2^K elements
// j0 + q d (d = t / 2^(K-1)) that those stages mix; stage l uses twiddle
// psi[(m + b) 2^l + sg] on sub-block sg of unit b's block. Same values as
// one radix-2 stage per pass (canonical), fewer shared-memory passes and
// barriers.
template <int K>
__device__ __forceinline__ void fwd_round(uint32_t* buf, int logn, int m, int logt,
                                          const uint32_t* psi, const uint32_t* psi_s,
                                          uint32_t p) {
  constexpr int E = 1 << K;
  const int n = 1 << logn;
  const int logd = logt - (K - 1);
  const int units = n >> K;
  for (int u = threadIdx.x; u < 2 * units; u += blockDim.x) {
    int b, o;
    unit_coords(u & (units - 1), logn - K, logd, b, o);
    const int j0 = (u >> (logn - K)) * n + (b << (logt + 1)) + o;
    uint32_t x[E];
#pragma unroll
    for (int q = 0; q < E; ++q) x[q] = buf[pad(j0 + (q << logd))];
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const int half = E >> (l + 1);
#pragma unroll
      for (int sg = 0; sg < (1 << l); ++sg) {
        const int w = ((m + b) << l) + sg;
        const uint32_t tw = psi[w];
        const uint32_t tws = psi_s[w];
#pragma unroll
        for (int q = 2 * sg * half; q < 2 * sg * half + half; ++q) {
          const uint32_t v = mul_shoup(x[q + half], tw, tws, p);
          const uint32_t y = x[q];
          x[q] = add_mod(y, v, p);
          x[q + half] = sub_mod(y, v, p);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < E; ++q) buf[pad(j0 + (q << logd))] = x[q];
  }
  __syncthreads();
}

// K <= 3 consecutive inverse (Gentleman-Sande) stages of both rows: the
// radix-2 stage with index base h and distance t = 2^logt (twiddle
// ipsi[h + i] on group i) and the K - 1 after it; unit elements j0 + q t,
// twiddle ipsi[(h >> l) + b 2^(K-l-1) + g] on pair group g of stage l. The
// last round also scales by N^-1.
template <int K>
__device__ __forceinline__ void inv_round(uint32_t* buf, int logn, int h, int logt,
                                          const uint32_t* ipsi, const uint32_t* ipsi_s,
                                          uint32_t p, bool scale, uint32_t ninv,
                                          uint32_t ninv_s) {
  constexpr int E = 1 << K;
  const int n = 1 << logn;
  const int units = n >> K;
  for (int u = threadIdx.x; u < 2 * units; u += blockDim.x) {
    int b, o;
    unit_coords(u & (units - 1), logn - K, logt, b, o);
    const int j0 = (u >> (logn - K)) * n + (b << (logt + K)) + o;
    uint32_t x[E];
#pragma unroll
    for (int q = 0; q < E; ++q) x[q] = buf[pad(j0 + (q << logt))];
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const int d = 1 << l;
#pragma unroll
      for (int g = 0; g < (E >> (l + 1)); ++g) {
        const int w = (h >> l) + (b << (K - l - 1)) + g;
        const uint32_t tw = ipsi[w];
        const uint32_t tws = ipsi_s[w];
#pragma unroll
        for (int qq = 0; qq < d; ++qq) {
          const int q = g * 2 * d + qq;
          const uint32_t y = x[q];
          const uint32_t v = x[q + d];
          x[q] = add_mod(y, v, p);
          x[q + d] = mul_shoup(sub_mod(y, v, p), tw, tws, p);
        }
      }
    }
    if (scale) {
#pragma unroll
      for (int q = 0; q < E; ++q) x[q] = mul_shoup(x[q], ninv, ninv_s, p);
    }
#pragma unroll
    for (int q = 0; q < E; ++q) buf[pad(j0 + (q << logt))] = x[q];
  }
  __syncthreads();
}

// The forward and inverse NTTs of the two padded rows, in rounds of three
// stages (the last round takes what is left). Every thread of the block
// calls them; the caller puts a barrier between filling buf and the call.
__device__ void ntt_fwd_padded(uint32_t* buf, int logn, const uint32_t* psi, const uint32_t* psi_s,
                               uint32_t p) {
  int m = 1;
  int logt = logn - 1;
  for (int left = logn; left > 0;) {
    const int k = left < 3 ? left : 3;
    if (k == 3) {
      fwd_round<3>(buf, logn, m, logt, psi, psi_s, p);
    } else if (k == 2) {
      fwd_round<2>(buf, logn, m, logt, psi, psi_s, p);
    } else {
      fwd_round<1>(buf, logn, m, logt, psi, psi_s, p);
    }
    m <<= k;
    logt -= k;
    left -= k;
  }
}

__device__ void ntt_inv_padded(uint32_t* buf, int logn, const uint32_t* ipsi,
                               const uint32_t* ipsi_s, uint32_t p, uint32_t ninv, uint32_t ninv_s) {
  int h = 1 << (logn - 1);
  int logt = 0;
  for (int left = logn; left > 0;) {
    const int k = left < 3 ? left : 3;
    if (k == 3) {
      inv_round<3>(buf, logn, h, logt, ipsi, ipsi_s, p, left == 3, ninv, ninv_s);
    } else if (k == 2) {
      inv_round<2>(buf, logn, h, logt, ipsi, ipsi_s, p, true, ninv, ninv_s);
    } else {
      inv_round<1>(buf, logn, h, logt, ipsi, ipsi_s, p, true, ninv, ninv_s);
    }
    h >>= k;
    logt += k;
    left -= k;
  }
}

}  // namespace tfhe
