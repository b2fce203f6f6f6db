// K3: `steps` consecutive rotation-free CMux steps of the blind rotation,
//     acc += (X^{a_j} - 1) * EP(BSK_j, acc),
// for gadget level 1 and k = 1.
//
// Replaces tfhe_tpu/ops/pallas_blind_rotate.py make_pallas_blind_rotate
// (pallas_call at pallas_blind_rotate.py:279; `kernel`/`_one_step`, with
// the Garner of `make_garner_pair`), driven by
// core/bootstrap._blind_rotate_fused. The TPU walks its grid in order and
// carries the accumulator through VMEM `steps` steps at a time; here one
// launch runs every step.
//
// Layout (K4's, csrc/multibit.cu): one block per (ciphertext, prime), the P
// blocks of a ciphertext in one thread-block cluster (cluster rank = prime).
// Each block keeps in shared memory, for the whole launch, the two residue
// rows of its prime (2 x N u32, padded one word in 32 against bank
// conflicts), its prime's twiddle rows (4 x N u32), a table of omega powers
// (R u32) and the step's C factors psi^((2 tq + 1) a): 49 KB at N = 2048,
// four blocks an SM. The u64 accumulator is split over the cluster: block r
// owns coefficients [lo, hi) of the 2N, ceil(2N / P), and keeps them in
// acc_out for the whole launch (16 MB at 512 ciphertexts, which stays in
// L2). Per step, block r:
//   1. fills the C-entry table psi^((2 tq + 1) a mod 2N) for the step's
//      exponent a and runs the forward NTTs of its two digit rows in rounds
//      of three radix-2 stages held in registers (rotate_device.cuh);
//   2. for each folded slot h, with consecutive threads on consecutive h so
//      that the key rows (d, c, prime r) are read coalesced, forms the inner
//      products ep_c = f0 . B[0,c] + f1 . B[1,c] (Shoup) and multiplies them
//      by NTT(X^a - 1) at h, m - 1 with m = psi^((2 j + 1) a) =
//      psi^((2 tq + 1) a mod 2N) . omega^(s a mod R), h = tq R + s holding
//      evaluation j = s C + tq at NTT slot bitrev(j); the Shoup companion of
//      m - 1 is computed exactly (shoup_companion). Nothing is gathered from
//      the 201 MB table of NTT(X^e - 1) rows, which only the plain version
//      reads;
//   3. runs the inverse NTTs the same way (canonical residues), then
//      cluster.sync();
//   4. adds garner_u32 of each owned coefficient's P residues, read through
//      distributed shared memory, shifted left by `shift`, to its
//      accumulator share in acc_out, and, unless this is the last step,
//      writes the new value's level-1 digit, reduced mod each prime with no
//      division (digit_residue), into every block's rows in place;
//   5. cluster.sync() again before the next step.
// This is K4's loop, except that the value is added to the accumulator
// rather than replacing it. Every residue is canonical before the inverse
// NTT and the Garner digits of a canonical residue tuple are unique, so the
// result equals the plain version (ops/blind_rotate_cuda.cmux_steps_plain)
// bit for bit, though the lazy reductions are ordered differently.
//
// Why: one block per ciphertext walked all three primes in sequence with
// the NTT one radix-2 stage per shared-memory pass, a signed 64-bit
// remainder per digit and seven in the Garner per coefficient, key rows read
// at scattered folded slots, and the (X^a - 1) row gathered from HBM; K4
// measured what removing each of those gives (PERF.md).
//
// Bound on this card, at 512 ciphertexts x 880 steps (N = 2048):
// operations (chip_smoke.py computes bytes and operations from the run's
// inputs): 12 NTTs of N points per step plus the pointwise Shoup multiplies
// and the Garner. What the design does not remove: every block reads its
// step's key rows for its prime (64 KB) from L2, ~88 GB per launch at 512
// ciphertexts; sharing one read over several ciphertexts is later work.

#include <cooperative_groups.h>

#include "rotate_device.cuh"

namespace cg = cooperative_groups;
using namespace tfhe;

// 256 threads, 4 blocks an SM (at most 64 registers). The accumulator
// share stays in acc_out rather than in registers: six u64 a thread at
// N = 2048 spilled 136 bytes at 64 registers and ran slower (107.3 against
// 101.2 ms at 512 ciphertexts x 880 steps on an H100, PERF.md).
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads, 4)
    k3_cmux(const int64_t* __restrict__ acc_in, int64_t* __restrict__ acc_out,
            const int32_t* __restrict__ exps, const uint32_t* __restrict__ bsk,
            const uint32_t* __restrict__ psi_pow, const uint32_t* __restrict__ tw,
            const uint32_t* __restrict__ pp, const uint32_t* __restrict__ gs, int batch, int steps,
            int logn, int logc, int nprimes, int base_log, int shift) {
  __shared__ uint32_t gsh[kGarnerShoupWords];  // the Garner and per-prime constants
  extern __shared__ uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  const int logr = logn - logc;
  const int rdim = 1 << logr;
  const int cdim = 1 << logc;
  uint32_t* res = smem;                 // (2, N) padded: residues mod this block's prime
  uint32_t* omega = smem + pad(2 * n);  // (R): psi^(2 C u), u < R
  uint32_t* twid = omega + rdim;        // (4, N): this prime's twiddle rows
  uint32_t* atab = twid + 4 * n;        // (C, 2): psi^((2 tq + 1) a) and Shoup
  const int r = (int)cluster.block_rank();  // this block's prime
  const size_t ct = blockIdx.x / nprimes;
  const uint32_t p = pp[r * 4];
  const uint32_t* psi = psi_pow + (size_t)r * 4 * n;  // psi^t, then Shoup, t < 2N
  for (int i = threadIdx.x; i < kGarnerShoupWords; i += kThreads) gsh[i] = gs[i];
  for (int u = threadIdx.x; u < rdim; u += kThreads) omega[u] = psi[u << (logc + 1)];
  for (int i = threadIdx.x; i < 4 * n; i += kThreads) twid[i] = tw[(size_t)r * 4 * n + i];
  const uint32_t ws1 = gs[52 + r];
  const uint32_t c1 = 0u - p * ws1;  // 2^32 mod p
  const uint32_t c1s = gs[56 + r];
  const int64_t* ain = acc_in + ct * 2 * n;
  for (int i = threadIdx.x; i < 2 * n; i += kThreads) {
    res[pad(i)] = digit_residue((uint64_t)ain[i], base_log, p, ws1);
  }
  // this block's accumulator share: coefficients [lo, hi) of the two rows
  const int share = (2 * n + nprimes - 1) / nprimes;
  const int lo = r * share;
  const int hi = min(2 * n, lo + share);
  int64_t* acc = acc_out + ct * 2 * n;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) acc[i] = ain[i];
  __syncthreads();
  const size_t step_rows = (size_t)4 * nprimes * 2 * n;  // one step's GGSW: (d, c, P, 2, N)
  const uint32_t* wr = bsk + (size_t)r * 2 * n;  // row (d, c) = (0, 0) of prime r
  const int wrow = nprimes * 2 * n;              // from row (d, c) to the next

  for (int j = 0; j < steps; ++j) {
    const int e = exps[(size_t)j * batch + ct];
    const size_t off = (size_t)j * step_rows;
    // the step's monomial factors; the NTT's barriers order them
    for (int tq = threadIdx.x; tq < cdim; tq += kThreads) {
      const int ta = ((2 * tq + 1) * e) & (2 * n - 1);
      atab[2 * tq] = psi[ta];
      atab[2 * tq + 1] = psi[2 * n + ta];
    }
    ntt_fwd_padded(res, logn, twid, twid + n, p);
    for (int h = threadIdx.x; h < n; h += kThreads) {
      // folded slot h = tq R + s holds evaluation jh = s C + tq, NTT slot bitrev(jh)
      const int s = h & (rdim - 1);
      const int tq = h >> logr;
      const int k = bitrev((s << logc) + tq, logn);
      const uint32_t f0 = res[pad(k)];
      const uint32_t f1 = res[pad(n + k)];
      // NTT(X^e - 1) at h = psi^((2 tq + 1) e mod 2N) . omega^(s e mod R) - 1
      const uint32_t m = sub_mod(mul_shoup(omega[(s * e) & (rdim - 1)], atab[2 * tq], atab[2 * tq + 1], p),
                                 1, p);
      const uint32_t ms = shoup_companion(m, p, ws1, c1, c1s);
      // BSK row (d, c, prime r) at w + (2 d + c) wrow: value at +0, Shoup companion at +N
      const uint32_t* w = wr + off + h;
      const uint32_t ep0 = add_mod(mul_shoup(f0, w[0], w[n], p), mul_shoup(f1, w[2 * wrow], w[2 * wrow + n], p), p);
      const uint32_t ep1 = add_mod(mul_shoup(f0, w[wrow], w[wrow + n], p),
                                   mul_shoup(f1, w[3 * wrow], w[3 * wrow + n], p), p);
      res[pad(k)] = mul_shoup(ep0, m, ms, p);
      res[pad(n + k)] = mul_shoup(ep1, m, ms, p);
    }
    __syncthreads();
    ntt_inv_padded(res, logn, twid + 2 * n, twid + 3 * n, p, pp[r * 4 + 1], pp[r * 4 + 2]);
    cluster.sync();  // every prime's residues are final
    // Coefficient i of every block's residue rows is read and written by
    // this one thread only, so the next step's digits go in place.
    const bool last = j + 1 == steps;
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
      uint32_t rq[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) rq[b] = b < nprimes ? cluster.map_shared_rank(res, b)[pad(i)] : 0;
      const uint64_t v = (uint64_t)acc[i] + (garner_u32(rq, nprimes, gsh) << shift);
      acc[i] = (int64_t)v;
      if (!last) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (b < nprimes) {
            cluster.map_shared_rank(res, b)[pad(i)] = digit_residue(v, base_log, gsh[b], gsh[52 + b]);
          }
        }
      }
    }
    cluster.sync();  // every block's rows hold the next digits; no peer still reads
  }
}

// The launch configuration of k3_cmux at N = 2^logn over nprimes primes:
// one block per (ciphertext, prime), the P blocks of a ciphertext in one
// cluster, the dynamic shared memory allowed. Returns a cudaError_t.
static int k3_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1], int batch, int logn,
                     int logc, int nprimes, void* stream) {
  const int n = 1 << logn;
  if (nprimes < 1 || nprimes > 4) return (int)cudaErrorInvalidValue;
  // padded residue rows, omega powers, twiddle rows, the step's psi factors
  const size_t words = (size_t)(2 * n + (2 * n >> 5)) + (n >> logc) + 4 * n + 2 * (1 << logc);
  const size_t smem = words * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(k3_cmux, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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

// How many clusters of k3_cmux can be resident on the device at once
// (cudaOccupancyMaxActiveClusters) at N = 2^logn over nprimes primes, into
// *clusters; 0 means no cluster of P such blocks can be scheduled. Returns
// a cudaError_t.
extern "C" int tfhe_cmux_max_active_clusters(int logn, int logc, int nprimes, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = k3_config(cfg, attr, 1, logn, logc, nprimes, nullptr);
  if (err != (int)cudaSuccess) return err;
  return (int)cudaOccupancyMaxActiveClusters(clusters, k3_cmux, &cfg);
}

// acc_in/acc_out (batch, 2, N) u64; exps (steps, batch) int32 exponents in
// [0, 2N); bsk (steps, 2, 2, P, 2, N) u32 Shoup pairs; psi_pow (P, 2, 2N) u32
// psi^t and Shoup companions; tw, pp the NTT tables; gs the garner_u32
// constants. Returns the launch's cudaError_t (a refused cluster launch
// included).
extern "C" int tfhe_cmux_steps(const void* acc_in, void* acc_out, const void* exps,
                               const void* bsk, const void* psi_pow, const void* tw,
                               const void* pp, const void* gs, int batch, int steps, int logn,
                               int logc, int nprimes, int base_log, int shift, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int cerr = k3_config(cfg, attr, batch, logn, logc, nprimes, stream);
  if (cerr != (int)cudaSuccess) return cerr;
  cudaError_t err = cudaLaunchKernelEx(&cfg, k3_cmux, (const int64_t*)acc_in, (int64_t*)acc_out,
                           (const int32_t*)exps, (const uint32_t*)bsk, (const uint32_t*)psi_pow,
                           (const uint32_t*)tw, (const uint32_t*)pp, (const uint32_t*)gs, batch,
                           steps, logn, logc, nprimes, base_log, shift);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
