// K1 and K2: batched negacyclic NTT mod each CRT prime, in the engine's
// folded layout.
//
// Replaces tfhe_tpu/ops/pallas_ntt.py make_pallas_ntt: `forward`/`fwd_kernel`
// (K1, pallas_call at pallas_ntt.py:494) and `inverse`/`inv_kernel` (K2,
// pallas_call at pallas_ntt.py:518). The TPU kernel splits operands into
// base-256 digit planes so the transform runs as int8/bf16 matrix products on
// the MXU; the card has native 32x32->64-bit integer products, so here each
// block transforms two rows of one prime with radix-2 butterflies and Shoup
// twiddles. The result is the same function: K1 outputs equal the plain
// version mod p (canonical here, lazy there), K2 outputs are canonical and
// equal it exactly.
//
// Where they run: once per keygen on the classic and multi-bit paths, and
// once each per blind-rotation step on every key that is not level 1 with
// k = 1 (core/bootstrap's loop of external products: K1 on the gadget
// digits, K2 after the transform-domain MAC).
//
// Bound on this card: bytes, by the formula of chip_smoke.py (each value
// read once, 4 P bytes of residues written, the butterflies' ~10 integer
// instructions at the card's 32-bit peak). In practice the integer
// instructions come close to the bytes' time: Hopper has half as many
// 32-bit integer lanes as fp32 lanes, and a first version of this design
// with canonical butterflies and run-time index arithmetic was bound by them
// (PERF.md). So the design keeps global traffic at its minimum, in whole
// 32-byte sectors, and spends as few integer instructions as it can:
// - one block per (row pair, prime), the two rows padded one word in 32 in
//   shared memory (rotate_device.cuh's `pad` and `unit_coords`), the NTT in
//   register rounds of three radix-2 stages, one shared-memory pass and one
//   barrier a round;
// - N is a template parameter, so every stride, padded offset and twiddle
//   index of a round folds into constants;
// - Harvey's lazy butterflies: forward values stay in [0, 4p), inverse ones
//   in [0, 2p) (p < 2^30), with one conditional subtract a butterfly instead
//   of three; K1 makes its residues canonical as it stores them, K2's last
//   round scales by N^-1 to canonical;
// - the folded layout's scatter (slot h = t R + s holds NTT slot
//   bitrev(s C + t)) is done in shared memory: K1 stores and K2 loads 16
//   bytes a thread at consecutive h, and each thread reads or writes its four
//   values at the slots the map gives (a warp's 32 slots fall in distinct
//   banks);
// - no `%`: an int32 magnitude |x| <= 2^31 is reduced by one Shoup quotient
//   against w = 1 (ws1 = floor(2^32 / p)) and negated for x < 0; a u64 as
//   lo + (2^32 mod p) hi, two Shoup multiplies and an add_mod; K2's lazy
//   input (any u32) by one Shoup reduction against w = 1.
// K1's P blocks of a row pair each read the pair's input rows; the second
// and third reads hit L2. A cluster of P blocks that read the rows once and
// shared the residues through distributed shared memory was slower on an
// H100 (PERF.md).
//
// Entry points return the launch's cudaError_t.

#include "rotate_device.cuh"

using namespace tfhe;

// 256 threads, 6 blocks an SM: 40 registers and no spill (8 blocks an SM
// capped them at 32 and spilled; PERF.md).
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 6;

// a * w mod p, lazily: in [0, 2p) for any u32 a, w < p, ws = floor(w 2^32 / p).
__device__ __forceinline__ uint32_t mul_shoup_lazy(uint32_t a, uint32_t w, uint32_t ws, uint32_t p) {
  return a * w - __umulhi(a, ws) * p;
}

__device__ __forceinline__ uint32_t below(uint32_t a, uint32_t m) { return a >= m ? a - m : a; }

// The NTT slot that folded slot h reads or writes: h = t R + s holds
// evaluation s C + t (N = R C).
__device__ __forceinline__ int slot_of_folded(int h, int logn, int logc) {
  const int logr = logn - logc;
  return bitrev(((h & ((1 << logr) - 1)) << logc) + (h >> logr), logn);
}

// The padded offsets of folded slots h + 1, h + 2, h + 3 from slot h, for h a
// multiple of 4 and R >= 128: slot_of_folded(h + e) = slot_of_folded(h) +
// slot_of_folded(e), a multiple of 32, so pad adds 1 for each 32.
__device__ __forceinline__ void quad_offsets(int logn, int logc, int (&off)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = slot_of_folded(e, logn, logc);
    off[e] = k + (k >> 5);
  }
}

// A signed 32-bit value mod p, canonical, for every int32 (|x| <= 2^31).
__device__ __forceinline__ uint32_t residue(int32_t x, uint32_t p, uint32_t ws1, uint32_t, uint32_t) {
  const uint32_t mag = x < 0 ? 0u - (uint32_t)x : (uint32_t)x;
  const uint32_t r = mul_shoup(mag, 1, ws1, p);
  return x < 0 && r ? p - r : r;
}

// A u64 mod p, canonical: lo + (2^32 mod p) hi.
__device__ __forceinline__ uint32_t residue(uint64_t x, uint32_t p, uint32_t ws1, uint32_t c32, uint32_t c32s) {
  return add_mod(mul_shoup((uint32_t)x, 1, ws1, p), mul_shoup((uint32_t)(x >> 32), c32, c32s, p), p);
}

// Forward stages S0 .. S0 + K - 1 (K <= 3) of both padded rows in registers:
// stage s has 2^s groups of distance t = N / 2^(s+1), and group i's
// butterflies (j, j + t) are twiddled by psi[2^s + i]. A unit is the 2^K
// elements j0 + q d (d = t_S0 / 2^(K-1)) those stages mix (fwd_round's unit,
// rotate_device.cuh). Values in [0, 4p) in and out.
template <int LOGN, int S0, int K>
__device__ __forceinline__ void fwd_lazy(uint32_t* buf, const uint32_t* __restrict__ psi,
                                         const uint32_t* __restrict__ psi_s, uint32_t p) {
  constexpr int N = 1 << LOGN;
  constexpr int E = 1 << K;
  constexpr int LOGT = LOGN - 1 - S0;
  constexpr int LOGD = LOGT - (K - 1);
  constexpr int D = 1 << LOGD;
  constexpr int M = 1 << S0;
  constexpr int UNITS = N >> K;
  const uint32_t p2 = 2 * p;
  for (int u = threadIdx.x; u < 2 * UNITS; u += blockDim.x) {
    int b, o;
    unit_coords(u & (UNITS - 1), LOGN - K, LOGD, b, o);
    // the unit lies in an aligned block of E d words, so its q-th element
    // is q d + (q d) / 32 words past the first in the padded row
    uint32_t* base = buf + pad((u >> (LOGN - K)) * N + (b << (LOGT + 1)) + o);
    uint32_t x[E];
#pragma unroll
    for (int q = 0; q < E; ++q) x[q] = base[q * D + ((q * D) >> 5)];
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const int half = E >> (l + 1);
#pragma unroll
      for (int sg = 0; sg < (1 << l); ++sg) {
        const int w = ((M + b) << l) + sg;
        const uint32_t tw = psi[w];
        const uint32_t tws = psi_s[w];
#pragma unroll
        for (int q = 2 * sg * half; q < 2 * sg * half + half; ++q) {
          const uint32_t a = below(x[q], p2);
          const uint32_t t = mul_shoup_lazy(x[q + half], tw, tws, p);
          x[q] = a + t;
          x[q + half] = a - t + p2;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < E; ++q) base[q * D + ((q * D) >> 5)] = x[q];
  }
  __syncthreads();
}

template <int LOGN, int S0>
__device__ __forceinline__ void fwd_rounds(uint32_t* buf, const uint32_t* psi, const uint32_t* psi_s, uint32_t p) {
  if constexpr (S0 < LOGN) {
    constexpr int K = LOGN - S0 < 3 ? LOGN - S0 : 3;
    fwd_lazy<LOGN, S0, K>(buf, psi, psi_s, p);
    fwd_rounds<LOGN, S0 + K>(buf, psi, psi_s, p);
  }
}

// Inverse (Gentleman-Sande) stages S0 .. S0 + K - 1 of both padded rows:
// stage s has distance t = 2^s and index base h = N / 2^(s+1), group i
// twiddled by ipsi[h + i] (inv_round's units, rotate_device.cuh). Values in
// [0, 2p) in and out; the last round scales by N^-1 to canonical.
template <int LOGN, int S0, int K>
__device__ __forceinline__ void inv_lazy(uint32_t* buf, const uint32_t* __restrict__ ipsi,
                                         const uint32_t* __restrict__ ipsi_s, uint32_t p, uint32_t ninv,
                                         uint32_t ninv_s) {
  constexpr int N = 1 << LOGN;
  constexpr int E = 1 << K;
  constexpr int LOGT = S0;
  constexpr int T = 1 << LOGT;
  constexpr int H = 1 << (LOGN - 1 - S0);
  constexpr int UNITS = N >> K;
  constexpr bool kLast = S0 + K == LOGN;
  const uint32_t p2 = 2 * p;
  for (int u = threadIdx.x; u < 2 * UNITS; u += blockDim.x) {
    int b, o;
    unit_coords(u & (UNITS - 1), LOGN - K, LOGT, b, o);
    uint32_t* base = buf + pad((u >> (LOGN - K)) * N + (b << (LOGT + K)) + o);
    uint32_t x[E];
#pragma unroll
    for (int q = 0; q < E; ++q) x[q] = base[q * T + ((q * T) >> 5)];
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const int d = 1 << l;
#pragma unroll
      for (int g = 0; g < (E >> (l + 1)); ++g) {
        const int w = (H >> l) + (b << (K - l - 1)) + g;
        const uint32_t tw = ipsi[w];
        const uint32_t tws = ipsi_s[w];
#pragma unroll
        for (int qq = 0; qq < d; ++qq) {
          const int q = g * 2 * d + qq;
          const uint32_t y = x[q];
          const uint32_t v = x[q + d];
          x[q] = below(y + v, p2);
          x[q + d] = mul_shoup_lazy(y - v + p2, tw, tws, p);
        }
      }
    }
    if constexpr (kLast) {
#pragma unroll
      for (int q = 0; q < E; ++q) x[q] = mul_shoup(x[q], ninv, ninv_s, p);
    }
#pragma unroll
    for (int q = 0; q < E; ++q) base[q * T + ((q * T) >> 5)] = x[q];
  }
  __syncthreads();
}

template <int LOGN, int S0>
__device__ __forceinline__ void inv_rounds(uint32_t* buf, const uint32_t* ipsi, const uint32_t* ipsi_s, uint32_t p,
                                           uint32_t ninv, uint32_t ninv_s) {
  if constexpr (S0 < LOGN) {
    constexpr int K = LOGN - S0 < 3 ? LOGN - S0 : 3;
    inv_lazy<LOGN, S0, K>(buf, ipsi, ipsi_s, p, ninv, ninv_s);
    inv_rounds<LOGN, S0 + K>(buf, ipsi, ipsi_s, p, ninv, ninv_s);
  }
}

// x (rows, N) int32 or u64 -> out (rows, P, N) u32 canonical residues,
// folded layout. Grid: P blocks per row pair (prime fastest, so the P reads
// of a pair's rows fall close in time and the later ones hit L2). gs holds
// the primes at [q], floor(2^32 / p_q) at [52 + q] and the Shoup companion
// of 2^32 mod p_q at [56 + q] (ops/ntt_cuda.garner_consts_shoup).
template <typename T, int LOGN>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    k1_forward(const T* __restrict__ x, uint32_t* __restrict__ out, int rows, int logc, int nprimes,
               const uint32_t* __restrict__ tw, const uint32_t* __restrict__ gs) {
  extern __shared__ uint32_t res[];  // (2, N) padded
  constexpr int N = 1 << LOGN;
  const int pair = blockIdx.x / nprimes;
  const int r = blockIdx.x - pair * nprimes;  // the prime
  const int nvals = min(2, rows - 2 * pair) * N;
  const uint32_t p = gs[r];
  const uint32_t ws1 = gs[52 + r];
  const uint32_t c32s = gs[56 + r];
  const uint32_t c32 = 0u - p * ws1;  // 2^32 mod p
  const T* xp = x + (size_t)pair * 2 * N;
  for (int i = threadIdx.x; i < 2 * N; i += blockDim.x) {
    res[pad(i)] = i < nvals ? residue(xp[i], p, ws1, c32, c32s) : 0u;
  }
  __syncthreads();
  const uint32_t* t = tw + (size_t)r * 4 * N;
  fwd_rounds<LOGN, 0>(res, t, t + N, p);
  // folded layout: 16 bytes a thread at consecutive h, made canonical
  int off[4];
  quad_offsets(LOGN, logc, off);
  const uint32_t p2 = 2 * p;
  for (int qd = threadIdx.x; qd < nvals >> 2; qd += blockDim.x) {
    const int row = qd >> (LOGN - 2);
    const int h = (qd << 2) & (N - 1);
    const uint32_t* src = res + pad(row * N + slot_of_folded(h, LOGN, logc));
    uint4 v;
    v.x = below(below(src[off[0]], p2), p);
    v.y = below(below(src[off[1]], p2), p);
    v.z = below(below(src[off[2]], p2), p);
    v.w = below(below(src[off[3]], p2), p);
    *reinterpret_cast<uint4*>(out + ((size_t)(2 * pair + row) * nprimes + r) * N + h) = v;
  }
}

// f (rows, P, N) u32 residues in the folded layout -> out (rows, P, N) u32
// canonical residues, natural order. Grid: P blocks per row pair.
template <int LOGN>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    k2_inverse(const uint32_t* __restrict__ f, uint32_t* __restrict__ out, int rows, int logc, int nprimes,
               const uint32_t* __restrict__ tw, const uint32_t* __restrict__ pp,
               const uint32_t* __restrict__ gs) {
  extern __shared__ uint32_t res[];  // (2, N) padded
  constexpr int N = 1 << LOGN;
  const int pair = blockIdx.x / nprimes;
  const int r = blockIdx.x - pair * nprimes;  // the prime
  const int nrows = min(2, rows - 2 * pair);
  const uint32_t p = pp[r * 4];
  const uint32_t ws1 = gs[52 + r];
  int off[4];
  quad_offsets(LOGN, logc, off);
  for (int qd = threadIdx.x; qd < N >> 1; qd += blockDim.x) {
    const int row = qd >> (LOGN - 2);
    const int h = (qd << 2) & (N - 1);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < nrows) v = *reinterpret_cast<const uint4*>(f + ((size_t)(2 * pair + row) * nprimes + r) * N + h);
    uint32_t* dst = res + pad(row * N + slot_of_folded(h, LOGN, logc));
    dst[off[0]] = mul_shoup(v.x, 1, ws1, p);
    dst[off[1]] = mul_shoup(v.y, 1, ws1, p);
    dst[off[2]] = mul_shoup(v.z, 1, ws1, p);
    dst[off[3]] = mul_shoup(v.w, 1, ws1, p);
  }
  __syncthreads();
  const uint32_t* t = tw + (size_t)r * 4 * N;
  inv_rounds<LOGN, 0>(res, t + 2 * N, t + 3 * N, p, pp[r * 4 + 1], pp[r * 4 + 2]);
  for (int qd = threadIdx.x; qd < nrows * (N >> 2); qd += blockDim.x) {
    const int i = qd << 2;
    const uint32_t* src = res + pad(i);  // four words in one run of 32
    *reinterpret_cast<uint4*>(out + ((size_t)(2 * pair + (i >> LOGN)) * nprimes + r) * N + (i & (N - 1))) =
        make_uint4(src[0], src[1], src[2], src[3]);
  }
}

static int threads_for(int n) {
  // one thread per unit of a three-stage round (2 rows x N/8), 64..256
  const int t = n >> 2;
  return t < 64 ? 64 : (t > kThreads ? kThreads : t);
}

static size_t smem_for(int n) { return (size_t)(2 * n + (2 * n >> 5)) * sizeof(uint32_t); }

template <int LOGN>
static void launch_forward(const void* x, int x_u64, void* out, int rows, int logc, int nprimes,
                           const uint32_t* tw, const uint32_t* gs, cudaStream_t stream) {
  const int n = 1 << LOGN;
  const dim3 grid((unsigned)(nprimes * ((rows + 1) / 2)));
  if (x_u64) {
    k1_forward<uint64_t, LOGN><<<grid, threads_for(n), smem_for(n), stream>>>(
        (const uint64_t*)x, (uint32_t*)out, rows, logc, nprimes, tw, gs);
  } else {
    k1_forward<int32_t, LOGN><<<grid, threads_for(n), smem_for(n), stream>>>(
        (const int32_t*)x, (uint32_t*)out, rows, logc, nprimes, tw, gs);
  }
}

template <int LOGN>
static void launch_inverse(const void* f, void* out, int rows, int logc, int nprimes, const uint32_t* tw,
                           const uint32_t* pp, const uint32_t* gs, cudaStream_t stream) {
  const int n = 1 << LOGN;
  k2_inverse<LOGN><<<nprimes * ((rows + 1) / 2), threads_for(n), smem_for(n), stream>>>(
      (const uint32_t*)f, (uint32_t*)out, rows, logc, nprimes, tw, pp, gs);
}

// Both kernels take N = 2^logn in [256, 4096] with R = N / 2^logc >= 128
// (the engine's split), at most 4 primes, and 16-byte aligned pointers.
static bool shape_ok(int logn, int logc, int nprimes) {
  return nprimes >= 1 && nprimes <= 4 && logn >= 8 && logn <= 12 && logn - logc >= 7;
}

// x (rows, N) int32 (x_u64 = 0) or u64; out (rows, P, N); tw (P, 4, N) and
// gs the tables of ops/ntt_cuda.
extern "C" int tfhe_ntt_forward(const void* x, int x_u64, void* out, int rows, int logn, int logc,
                                int nprimes, const void* tw, const void* gs, void* stream) {
  if (!shape_ok(logn, logc, nprimes)) return (int)cudaErrorInvalidValue;
  const uint32_t* t = (const uint32_t*)tw;
  const uint32_t* g = (const uint32_t*)gs;
  cudaStream_t s = (cudaStream_t)stream;
  switch (logn) {
    case 8: launch_forward<8>(x, x_u64, out, rows, logc, nprimes, t, g, s); break;
    case 9: launch_forward<9>(x, x_u64, out, rows, logc, nprimes, t, g, s); break;
    case 10: launch_forward<10>(x, x_u64, out, rows, logc, nprimes, t, g, s); break;
    case 11: launch_forward<11>(x, x_u64, out, rows, logc, nprimes, t, g, s); break;
    default: launch_forward<12>(x, x_u64, out, rows, logc, nprimes, t, g, s); break;
  }
  return (int)cudaGetLastError();
}

// f, out (rows, P, N); tw, pp, gs the tables of ops/ntt_cuda.
extern "C" int tfhe_ntt_inverse(const void* f, void* out, int rows, int logn, int logc, int nprimes,
                                const void* tw, const void* pp, const void* gs, void* stream) {
  if (!shape_ok(logn, logc, nprimes)) return (int)cudaErrorInvalidValue;
  const uint32_t* t = (const uint32_t*)tw;
  const uint32_t* q = (const uint32_t*)pp;
  const uint32_t* g = (const uint32_t*)gs;
  cudaStream_t s = (cudaStream_t)stream;
  switch (logn) {
    case 8: launch_inverse<8>(f, out, rows, logc, nprimes, t, q, g, s); break;
    case 9: launch_inverse<9>(f, out, rows, logc, nprimes, t, q, g, s); break;
    case 10: launch_inverse<10>(f, out, rows, logc, nprimes, t, q, g, s); break;
    case 11: launch_inverse<11>(f, out, rows, logc, nprimes, t, q, g, s); break;
    default: launch_inverse<12>(f, out, rows, logc, nprimes, t, q, g, s); break;
  }
  return (int)cudaGetLastError();
}
