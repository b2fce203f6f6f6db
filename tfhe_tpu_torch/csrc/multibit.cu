// K4: all n/g group steps of the multi-bit blind rotation,
//     acc <- EP( sum_v (prod_{i in v} m_i) . BSK_{j,v} , acc ),
// with m_i = NTT(X^{a[g j + i]}), for gadget level 1 and k = 1, g in {2, 3, 4}.
// The result REPLACES the accumulator.
//
// Replaces tfhe_tpu/ops/pallas_multibit.py make_pallas_multibit_step
// (pallas_call at pallas_multibit.py:184; `_one_step`, `_horner`), which the
// JAX caller multibit_rotate_fused / _scan_rotate launches once per group
// inside lax.scan. Here one launch runs every group.
//
// Layout: one block per (ciphertext, prime), the P blocks of a ciphertext in
// one thread-block cluster (cluster rank = prime). Each block keeps in shared
// memory, for the whole launch, the two residue rows of its prime (2 x N u32,
// padded one word in 32 against bank conflicts), its prime's twiddle rows
// (4 x N u32) and a table of omega powers (R u32): 49 KB at N = 2048. The
// accumulator itself never sits there. Per group, block r:
//   1. fills a small table of psi^((2 tq + 1) e_i mod 2N), tq < C, for the
//      group's g exponents, and runs the forward NTTs of its two digit rows in
//      rounds of three radix-2 stages held in registers (fwd_round: four
//      barriers at N = 2048, where one stage per pass took eleven);
//   2. for each folded slot h, with consecutive threads on consecutive h so
//      that the key rows are read coalesced, and each output row c, forms the
//      2^g inner products f0 . B[v,0,c] + f1 . B[v,1,c] (Shoup) and the Horner
//      fold over the g bits, x[v] += m_b . x[v + 2^b] (b = 0..g-1, v with bits
//      0..b clear), in registers. Slot h = tq R + s holds evaluation
//      j = s C + tq at NTT slot bitrev(j), so the scattered accesses are the
//      shared-memory ones. The monomial m_b = NTT(X^e)[h] = psi^((2j+1) e) is
//      psi^((2 tq + 1) e mod 2N) . omega^(s e mod R), omega = psi^(2C), both
//      factors from shared memory; their product's Shoup companion is
//      computed exactly (shoup_companion). Nothing is gathered from the
//      201 MB table of NTT(X^e) rows;
//   3. runs the inverse NTTs the same way (canonical residues), then
//      cluster.sync();
//   4. reconstructs its third of the 2N coefficients with garner_u32 (u32
//      Shoup, no `%`), reading the peers' residues through distributed shared
//      memory, and writes the next group's level-1 digit of value << shift,
//      reduced mod each prime with no `%` (digit_residue), into every block's
//      rows in place (or, after the last group, the value to acc_out);
//   5. cluster.sync() again before the next group.
// Every residue is canonical before the inverse NTT and the Garner digits of
// a canonical residue tuple are unique, so the result equals the plain
// version (ops/multibit_cuda.group_steps_plain) bit for bit, though the lazy
// reductions are ordered differently.
//
// Why: one block per ciphertext walked all groups for all primes, so a
// launch's latency was 294 x one block's full group time whatever the batch,
// and the ERC20 carry chain's launches of 64-128 rows filled under half the
// card. Splitting the primes over a cluster cuts a block's work per group to
// about 1/P and triples the blocks of a small launch. The measured steps, and
// the versions that lost (a 32 KB accumulator copy per block, monomials read
// at scattered global addresses, keys read past L1), are in PERF.md.
//
// Bound on this card, at 512 ciphertexts x 294 groups (GROUP_3, N = 2048):
// operations (chip_smoke.py computes bytes and operations from the run's
// inputs): 12 NTTs of N points per group plus 2 (2 2^g + 2^g - 1) Shoup
// multiplies per coefficient and prime, at the 67 T/s 32-bit rate. What the
// design does not remove: every block reads its group's key rows for its
// prime (0.5 MB at g = 3) from L2, ~231 GB per launch at 512 ciphertexts;
// sharing one read over several ciphertexts is later work.

#include <cooperative_groups.h>

#include "rotate_device.cuh"

namespace cg = cooperative_groups;
using namespace tfhe;

// Block size and register cap: 256 threads, 4 blocks an SM (at most 64
// registers) for g = 2, 3; g = 4 keeps 16 inner products live and takes 3
// blocks an SM (at most 80 registers), where 64 spilled.
constexpr int kThreads = 256;

template <int G>
__global__ void __launch_bounds__(kThreads, G == 4 ? 3 : 4)
    k4_group_steps(const int64_t* __restrict__ acc_in, int64_t* __restrict__ acc_out,
                   const int32_t* __restrict__ a, const uint32_t* __restrict__ bsk,
                   const uint32_t* __restrict__ psi_pow, const uint32_t* __restrict__ tw,
                   const uint32_t* __restrict__ pp, const uint32_t* __restrict__ gs, int batch,
                   int groups, int logn, int logc, int nprimes, int base_log, int shift) {
  constexpr int V = 1 << G;
  __shared__ uint32_t gsh[kGarnerShoupWords];  // the Garner and per-prime constants
  extern __shared__ uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  const int logr = logn - logc;
  const int rdim = 1 << logr;
  uint32_t* res = smem;                 // (2, N) padded: residues mod this block's prime
  uint32_t* omega = smem + pad(2 * n);  // (R): psi^(2 C u), u < R
  uint32_t* twid = omega + rdim;        // (4, N): this prime's twiddle rows
  uint32_t* atab = twid + 4 * n;        // (G, C, 2): psi^((2 tq + 1) e_i) and Shoup
  const int cdim = 1 << logc;
  const int r = (int)cluster.block_rank();  // this block's prime
  const size_t ct = blockIdx.x / nprimes;
  const uint32_t p = pp[r * 4];
  const uint32_t* psi = psi_pow + (size_t)r * 4 * n;  // psi^t, then Shoup, t < 2N
  for (int i = threadIdx.x; i < kGarnerShoupWords; i += blockDim.x) gsh[i] = gs[i];
  for (int u = threadIdx.x; u < rdim; u += blockDim.x) omega[u] = psi[u << (logc + 1)];
  for (int i = threadIdx.x; i < 4 * n; i += blockDim.x) twid[i] = tw[(size_t)r * 4 * n + i];
  const uint32_t ws1 = gs[52 + r];
  const uint32_t c1 = 0u - p * ws1;  // 2^32 mod p
  const uint32_t c1s = gs[56 + r];
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    res[pad(i)] = digit_residue((uint64_t)acc_in[ct * 2 * n + i], base_log, p, ws1);
  }
  __syncthreads();
  const size_t pat_rows = (size_t)4 * nprimes * 2 * n;  // one pattern's GGSW: (d, c, P, 2, N)
  // this block's Garner share: coefficients [lo, hi) of the two rows
  const int share = (2 * n + nprimes - 1) / nprimes;
  const int lo = r * share;
  const int hi = min(2 * n, lo + share);

  for (int j = 0; j < groups; ++j) {
    int e[G];
#pragma unroll
    for (int i = 0; i < G; ++i) e[i] = a[(size_t)(G * j + i) * batch + ct];
    const uint32_t* bg = bsk + (size_t)j * V * pat_rows;
    // the first monomial factors of this group; the NTT's barriers order them
#pragma unroll
    for (int i = 0; i < G; ++i) {
      for (int tq = threadIdx.x; tq < cdim; tq += blockDim.x) {
        const int ta = ((2 * tq + 1) * e[i]) & (2 * n - 1);
        atab[2 * (i * cdim + tq)] = psi[ta];
        atab[2 * (i * cdim + tq) + 1] = psi[2 * n + ta];
      }
    }
    ntt_fwd_padded(res, logn, twid, twid + n, p);
    for (int h = threadIdx.x; h < n; h += blockDim.x) {
      // folded slot h = tq R + s holds evaluation jh = s C + tq, NTT slot bitrev(jh)
      const int s = h & (rdim - 1);
      const int tq = h >> logr;
      const int k = bitrev((s << logc) + tq, logn);
      const uint32_t f0 = res[pad(k)];
      const uint32_t f1 = res[pad(n + k)];
      // NTT(X^e) at h = psi^((2 jh + 1) e) = psi^((2 tq + 1) e mod 2N) . omega^(s e mod R)
      uint32_t mv[G], ms[G];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const uint32_t* ai = atab + 2 * ((i << logc) + tq);
        mv[i] = mul_shoup(omega[(s * e[i]) & (rdim - 1)], ai[0], ai[1], p);
        ms[i] = shoup_companion(mv[i], p, ws1, c1, c1s);
      }
      uint32_t outc[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        uint32_t x[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          // pattern v's BSK row (d, c, prime r): value at +0, Shoup companion at +N
          const uint32_t* w0 = bg + v * pat_rows + ((size_t)((0 * 2 + c) * nprimes + r) * 2) * n;
          const uint32_t* w1 = bg + v * pat_rows + ((size_t)((1 * 2 + c) * nprimes + r) * 2) * n;
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
      res[pad(k)] = outc[0];
      res[pad(n + k)] = outc[1];
    }
    __syncthreads();
    ntt_inv_padded(res, logn, twid + 2 * n, twid + 3 * n, p, pp[r * 4 + 1], pp[r * 4 + 2]);
    cluster.sync();  // every prime's residues are final
    // Coefficient i of every block's residue rows is read and written by
    // this one thread only, so the next group's digits go in place.
    const bool last = j + 1 == groups;
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      uint32_t rq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) rq[q] = q < nprimes ? cluster.map_shared_rank(res, q)[pad(i)] : 0;
      const uint64_t x = garner_u32(rq, nprimes, gsh) << shift;
      if (last) {
        acc_out[ct * 2 * n + i] = (int64_t)x;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q < nprimes) {
            const uint32_t d = digit_residue(x, base_log, gsh[q], gsh[52 + q]);
            cluster.map_shared_rank(res, q)[pad(i)] = d;
          }
        }
      }
    }
    cluster.sync();  // every block's rows hold the next digits; no peer still reads
  }
}

// The launch configuration of k4_group_steps<G> at N = 2^logn over nprimes
// primes: one block per (ciphertext, prime), the P blocks of a ciphertext in
// one cluster, the dynamic shared memory allowed. Returns a cudaError_t.
template <int G>
static int k4_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1], int batch, int logn,
                     int logc, int nprimes, void* stream) {
  const int n = 1 << logn;
  // padded residue rows, omega powers, twiddle rows, the group's psi factors
  const size_t words = (size_t)(2 * n + (2 * n >> 5)) + (n >> logc) + 4 * n + 2 * G * (1 << logc);
  const size_t smem = words * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(k4_group_steps<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nprimes;  // the P blocks of one ciphertext
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3((unsigned)(nprimes * batch));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaSuccess;
}

template <int G>
static int launch(const void* acc_in, void* acc_out, const void* a, const void* bsk,
                  const void* psi_pow, const void* tw, const void* pp, const void* gs, int batch,
                  int groups, int logn, int logc, int nprimes, int base_log, int shift,
                  void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int cerr = k4_config<G>(cfg, attr, batch, logn, logc, nprimes, stream);
  if (cerr != (int)cudaSuccess) return cerr;
  cudaError_t err = cudaLaunchKernelEx(&cfg, k4_group_steps<G>, (const int64_t*)acc_in, (int64_t*)acc_out,
                           (const int32_t*)a, (const uint32_t*)bsk, (const uint32_t*)psi_pow,
                           (const uint32_t*)tw, (const uint32_t*)pp, (const uint32_t*)gs, batch,
                           groups, logn, logc, nprimes, base_log, shift);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int G>
static int max_active_clusters(int logn, int logc, int nprimes, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = k4_config<G>(cfg, attr, 1, logn, logc, nprimes, nullptr);
  if (err != (int)cudaSuccess) return err;
  return (int)cudaOccupancyMaxActiveClusters(clusters, k4_group_steps<G>, &cfg);
}

// How many clusters of k4_group_steps<group_size> can be resident on the
// device at once (cudaOccupancyMaxActiveClusters) at N = 2^logn over
// nprimes primes, into *clusters; 0 means no cluster of P such blocks can
// be scheduled. Returns a cudaError_t.
extern "C" int tfhe_multibit_max_active_clusters(int group_size, int logn, int logc, int nprimes,
                                                 int* clusters) {
  if (nprimes < 1 || nprimes > 4) return (int)cudaErrorInvalidValue;
  switch (group_size) {
    case 2: return max_active_clusters<2>(logn, logc, nprimes, clusters);
    case 3: return max_active_clusters<3>(logn, logc, nprimes, clusters);
    case 4: return max_active_clusters<4>(logn, logc, nprimes, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

// acc_in/acc_out (batch, 2, N) u64; a (groups * g, batch) int32 exponents in
// [0, 2N); bsk (groups, 2^g, 2, 2, P, 2, N) u32 Shoup pairs; psi_pow (P, 2, 2N)
// u32 psi^t and Shoup companions; gs the garner_u32 constants. Returns the
// launch's cudaError_t (a refused cluster launch included).
extern "C" int tfhe_multibit_group_steps(const void* acc_in, void* acc_out, const void* a,
                                         const void* bsk, const void* psi_pow, const void* tw,
                                         const void* pp, const void* gs, int batch, int groups,
                                         int group_size, int logn, int logc, int nprimes,
                                         int base_log, int shift, void* stream) {
  if (nprimes < 1 || nprimes > 4) return (int)cudaErrorInvalidValue;
  switch (group_size) {
    case 2:
      return launch<2>(acc_in, acc_out, a, bsk, psi_pow, tw, pp, gs, batch, groups, logn, logc,
                       nprimes, base_log, shift, stream);
    case 3:
      return launch<3>(acc_in, acc_out, a, bsk, psi_pow, tw, pp, gs, batch, groups, logn, logc,
                       nprimes, base_log, shift, stream);
    case 4:
      return launch<4>(acc_in, acc_out, a, bsk, psi_pow, tw, pp, gs, batch, groups, logn, logc,
                       nprimes, base_log, shift, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
