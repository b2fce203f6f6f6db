// K4: all n/g group steps of the multi-bit blind rotation,
//     acc <- EP( sum_v (prod_{i in v} m_i) . BSK_{j,v} , acc ),
// with m_i = NTT(X^{a[g j + i]}), for gadget level 1 and k = 1, g in {2, 3, 4},
// one block per ciphertext. The result REPLACES the accumulator.
//
// Replaces tfhe_tpu/ops/pallas_multibit.py make_pallas_multibit_step
// (pallas_call at pallas_multibit.py:184; `_one_step`, `_horner`), which the
// JAX caller multibit_rotate_fused / _scan_rotate launches once per group
// inside lax.scan. Here one launch runs every group: each block owns one
// ciphertext and loops over the groups with its accumulator resident in
// shared memory (2 x N u64 = 32 KB at N = 2048) beside the residue rows of
// all primes (P x 2 x N u32 = 48 KB), K3's layout. Each group, per prime:
// level-1 decomposition of both accumulator rows, forward NTT
// (ntt_device.cuh); then for each coefficient, at its folded slot h, and
// each output row c, the 2^g inner products f0 . B[v,0,c] + f1 . B[v,1,c]
// (Shoup) and the Horner fold over the g bits,
//     x[v] += m_b . x[v + 2^b]   for b = 0..g-1,  v with bits 0..b clear,
// with the g monomial rows m_i read straight from the NTT(X^e) table at the
// exponents of the mod-switched mask (no gathered copy, no subset sums):
// 2^g values per c, all in registers. Then inverse NTT, Garner (garner_u64)
// and acc = value << shift. Every residue is canonical before the inverse
// NTT, so the result depends only on the values mod p and equals the plain
// version (ops/multibit_cuda.group_steps_plain) bit for bit, though the
// lazy reductions are ordered differently.
//
// Bound on this card, at 512 ciphertexts x 294 groups (GROUP_3, N = 2048):
// bytes and operations come out close (chip_smoke.py computes both from the
// run's inputs). Bytes: each ciphertext and group gathers g x P x 2 x N x 4 B
// = 147 KB of monomial rows, ~22 GB in all, since the 201 MB table does not
// fit the 50 MB L2; the 462 MB key is shared by all blocks of a group
// through L2 and read from memory about once. Operations: 12 NTTs of N
// points per group plus 2 (2 2^g + 2^g - 1) Shoup multiplies per coefficient
// and prime, at the 67 T/s 32-bit rate. The design is K3's: simple and
// right first; wgmma, TMA and bank-conflict-free butterflies wait. The one
// tuning step is the register cap below: it lets two blocks share an SM.

#include "ntt_device.cuh"

using namespace tfhe;

// At most 512 threads (ntt_threads), and registers capped so that two
// blocks fit on an SM beside their 2 x 80 KB of shared memory: uncapped,
// ptxas took 72 registers at g = 4 and one block ran per SM.
template <int G>
__global__ void __launch_bounds__(512, 2)
    k4_group_steps(const int64_t* __restrict__ acc_in, int64_t* __restrict__ acc_out,
                   const int32_t* __restrict__ a, const uint32_t* __restrict__ bsk,
                   const uint32_t* __restrict__ mono, const uint32_t* __restrict__ tw,
                   const uint32_t* __restrict__ pp, const uint64_t* __restrict__ gc, int batch,
                   int groups, int logn, int logc, int nprimes, int base_log, int shift) {
  constexpr int V = 1 << G;
  extern __shared__ uint64_t smem[];
  const int n = 1 << logn;
  uint64_t* acc = smem;                       // (2, N)
  uint32_t* res = (uint32_t*)(smem + 2 * n);  // (P, 2, N)
  const size_t ct = blockIdx.x;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    acc[i] = (uint64_t)acc_in[ct * 2 * n + i];
  }
  __syncthreads();
  const uint64_t half = 1ull << (63 - base_log);
  const int64_t b_half = 1ll << (base_log - 1);
  const int64_t b_full = 1ll << base_log;
  const size_t pat_rows = (size_t)4 * nprimes * 2 * n;  // one pattern's GGSW: (d, c, P, 2, N)

  for (int j = 0; j < groups; ++j) {
    int e[G];
#pragma unroll
    for (int i = 0; i < G; ++i) e[i] = a[(size_t)(G * j + i) * batch + ct];
    const uint32_t* bg = bsk + (size_t)j * V * pat_rows;
    for (int pi = 0; pi < nprimes; ++pi) {
      const uint32_t p = pp[pi * 4];
      const uint32_t* t = tw + (size_t)pi * 4 * n;
      uint32_t* buf = res + (size_t)pi * 2 * n;
      for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
        const int64_t state = (int64_t)((acc[i] + half) >> (64 - base_log));
        const int64_t d = state >= b_half ? state - b_full : state;
        const int64_t r = d % (int64_t)p;
        buf[i] = (uint32_t)(r < 0 ? r + p : r);
      }
      __syncthreads();
      ntt_fwd_rows(buf, 2, logn, t, t + n, p);
      const uint32_t* m[G];
#pragma unroll
      for (int i = 0; i < G; ++i) m[i] = mono + ((size_t)e[i] * nprimes + pi) * 2 * n;
      for (int k = threadIdx.x; k < n; k += blockDim.x) {
        const int h = folded_slot(k, logn, logc);
        const uint32_t f0 = buf[k];
        const uint32_t f1 = buf[n + k];
        uint32_t mv[G], ms[G];
#pragma unroll
        for (int i = 0; i < G; ++i) {
          mv[i] = m[i][h];
          ms[i] = m[i][n + h];
        }
        uint32_t outc[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          uint32_t x[V];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            // pattern v's BSK row (d, c, prime): value at +0, Shoup companion at +N
            const uint32_t* w0 = bg + v * pat_rows + ((size_t)((0 * 2 + c) * nprimes + pi) * 2) * n;
            const uint32_t* w1 = bg + v * pat_rows + ((size_t)((1 * 2 + c) * nprimes + pi) * 2) * n;
            x[v] = add_mod(mul_shoup(f0, w0[h], w0[n + h], p), mul_shoup(f1, w1[h], w1[n + h], p), p);
          }
#pragma unroll
          for (int b = 0; b < G; ++b) {
#pragma unroll
            for (int v = 0; v < V; v += 2 << b) {
              x[v] = add_mod(x[v], mul_shoup(x[v + (1 << b)], mv[b], ms[b], p), p);
            }
          }
          outc[c] = x[0];
        }
        buf[k] = outc[0];
        buf[n + k] = outc[1];
      }
      __syncthreads();
      ntt_inv_rows(buf, 2, logn, t + 2 * n, t + 3 * n, p, pp[pi * 4 + 1], pp[pi * 4 + 2]);
    }
    // Garner: canonical residues -> signed CRT value mod 2^64; replaces acc
    for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
      acc[i] = garner_u64(res + i, (size_t)2 * n, nprimes, gc) << shift;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    acc_out[ct * 2 * n + i] = (int64_t)acc[i];
  }
}

template <int G>
static int launch(const void* acc_in, void* acc_out, const void* a, const void* bsk,
                  const void* mono, const void* tw, const void* pp, const void* gc, int batch,
                  int groups, int logn, int logc, int nprimes, int base_log, int shift,
                  void* stream) {
  const int n = 1 << logn;
  const size_t smem = (size_t)2 * n * sizeof(uint64_t) + (size_t)nprimes * 2 * n * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(k4_group_steps<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  k4_group_steps<G><<<batch, ntt_threads(n), smem, (cudaStream_t)stream>>>(
      (const int64_t*)acc_in, (int64_t*)acc_out, (const int32_t*)a, (const uint32_t*)bsk,
      (const uint32_t*)mono, (const uint32_t*)tw, (const uint32_t*)pp, (const uint64_t*)gc, batch,
      groups, logn, logc, nprimes, base_log, shift);
  return (int)cudaGetLastError();
}

// acc_in/acc_out (batch, 2, N) u64; a (groups * g, batch) int32 exponents in
// [0, 2N); bsk (groups, 2^g, 2, 2, P, 2, N) u32 Shoup pairs; mono (2N, P, 2, N)
// u32 Shoup pairs of NTT(X^e). Returns cudaGetLastError() of the launch.
extern "C" int tfhe_multibit_group_steps(const void* acc_in, void* acc_out, const void* a,
                                         const void* bsk, const void* mono, const void* tw,
                                         const void* pp, const void* gc, int batch, int groups,
                                         int group_size, int logn, int logc, int nprimes,
                                         int base_log, int shift, void* stream) {
  switch (group_size) {
    case 2:
      return launch<2>(acc_in, acc_out, a, bsk, mono, tw, pp, gc, batch, groups, logn, logc,
                       nprimes, base_log, shift, stream);
    case 3:
      return launch<3>(acc_in, acc_out, a, bsk, mono, tw, pp, gc, batch, groups, logn, logc,
                       nprimes, base_log, shift, stream);
    case 4:
      return launch<4>(acc_in, acc_out, a, bsk, mono, tw, pp, gc, batch, groups, logn, logc,
                       nprimes, base_log, shift, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
