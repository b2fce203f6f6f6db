// K3: `steps` consecutive rotation-free CMux steps of the blind rotation,
//     acc += (X^{a_j} - 1) * EP(BSK_j, acc),
// for gadget level 1 and k = 1, one block per ciphertext.
//
// Replaces tfhe_tpu/ops/pallas_blind_rotate.py make_pallas_blind_rotate
// (`kernel`/`_one_step`, with `make_garner_pair`), driven by
// core/bootstrap._blind_rotate_fused. The TPU walks its grid in order and
// carries the accumulator through VMEM `steps` steps at a time; here blocks
// run in no order, so each block owns one ciphertext and loops over all the
// steps it is given with its accumulator resident in shared memory
// (2 x N u64 = 32 KB at N = 2048) beside the per-prime residue rows
// (P x 2 x N u32 = 48 KB). Each step, per prime: level-1 decomposition of the
// two accumulator rows, forward NTT (ntt_device.cuh), EP multiply-accumulate
// against the Shoup BSK rows, pointwise Shoup multiply by the row
// NTT(X^{a_j} - 1) read straight from the monomial table (no gathered copy),
// inverse NTT; then Garner in native u64 (no u32-pair emulation) and
// acc += value << shift. The result equals the plain version bit for bit.
//
// Bound on this card: integer operations. Per ciphertext and step the block
// runs 12 NTTs of N points (3 primes x 2 rows x forward + inverse), ~1.9 M
// 32-bit integer instructions, against ~100 KB of key and table rows that
// all blocks share through L2 (the BSK rows of a step) or that are
// data-dependent gathers (the monomial rows). The design keeps every
// intermediate in shared memory; the butterflies' bank conflicts and the
// scattered folded-layout reads are what a later, faster version removes.
//
// Garner constants: see garner_u64 in ntt_device.cuh.

#include "ntt_device.cuh"

using namespace tfhe;

__global__ void k3_cmux(const int64_t* __restrict__ acc_in, int64_t* __restrict__ acc_out,
                        const int32_t* __restrict__ exps, const uint32_t* __restrict__ bsk,
                        const uint32_t* __restrict__ rot, const uint32_t* __restrict__ tw,
                        const uint32_t* __restrict__ pp, const uint64_t* __restrict__ gc,
                        int batch, int steps, int logn, int logc, int nprimes, int base_log,
                        int shift) {
  extern __shared__ uint64_t smem[];
  const int n = 1 << logn;
  uint64_t* acc = smem;                         // (2, N)
  uint32_t* res = (uint32_t*)(smem + 2 * n);    // (P, 2, N)
  const size_t ct = blockIdx.x;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    acc[i] = (uint64_t)acc_in[ct * 2 * n + i];
  }
  __syncthreads();
  const uint64_t half = 1ull << (63 - base_log);
  const int64_t b_half = 1ll << (base_log - 1);
  const int64_t b_full = 1ll << base_log;
  const size_t step_rows = (size_t)4 * nprimes * 2 * n;  // (d, c, P, 2, N)

  for (int s = 0; s < steps; ++s) {
    const int e = exps[(size_t)s * batch + ct];
    const uint32_t* bs = bsk + (size_t)s * step_rows;
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
      const uint32_t* rv = rot + ((size_t)e * nprimes + pi) * 2 * n;
      for (int k = threadIdx.x; k < n; k += blockDim.x) {
        const int h = folded_slot(k, logn, logc);
        const uint32_t f0 = buf[k];
        const uint32_t f1 = buf[n + k];
        const uint32_t r_v = rv[h];
        const uint32_t r_s = rv[n + h];
        uint32_t outc[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          // BSK row (d, c, prime): value at +0, Shoup companion at +N
          const uint32_t* w0 = bs + ((size_t)((0 * 2 + c) * nprimes + pi) * 2) * n;
          const uint32_t* w1 = bs + ((size_t)((1 * 2 + c) * nprimes + pi) * 2) * n;
          uint32_t ep = add_mod(mul_shoup(f0, w0[h], w0[n + h], p),
                                mul_shoup(f1, w1[h], w1[n + h], p), p);
          outc[c] = mul_shoup(ep, r_v, r_s, p);
        }
        buf[k] = outc[0];
        buf[n + k] = outc[1];
      }
      __syncthreads();
      ntt_inv_rows(buf, 2, logn, t + 2 * n, t + 3 * n, p, pp[pi * 4 + 1], pp[pi * 4 + 2]);
    }
    // Garner: canonical residues -> signed CRT value mod 2^64, << shift
    for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
      acc[i] += garner_u64(res + i, (size_t)2 * n, nprimes, gc) << shift;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    acc_out[ct * 2 * n + i] = (int64_t)acc[i];
  }
}

extern "C" int tfhe_cmux_steps(const void* acc_in, void* acc_out, const void* exps,
                               const void* bsk, const void* rot, const void* tw,
                               const void* pp, const void* gc, int batch, int steps, int logn,
                               int logc, int nprimes, int base_log, int shift, void* stream) {
  const int n = 1 << logn;
  const size_t smem = (size_t)2 * n * sizeof(uint64_t) + (size_t)nprimes * 2 * n * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(k3_cmux, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  k3_cmux<<<batch, ntt_threads(n), smem, (cudaStream_t)stream>>>(
      (const int64_t*)acc_in, (int64_t*)acc_out, (const int32_t*)exps, (const uint32_t*)bsk,
      (const uint32_t*)rot, (const uint32_t*)tw, (const uint32_t*)pp, (const uint64_t*)gc, batch,
      steps, logn, logc, nprimes, base_log, shift);
  return (int)cudaGetLastError();
}
