// K1 and K2: batched negacyclic NTT mod each CRT prime, in the engine's
// folded layout.
//
// Replaces tfhe_tpu/ops/pallas_ntt.py make_pallas_ntt: `forward`/`fwd_kernel`
// (K1) and `inverse`/`inv_kernel` (K2). The TPU kernel splits operands into
// base-256 digit planes so the transform runs as int8/bf16 matrix products on
// the MXU; the card has native 32x32->64-bit integer products, so here each
// (row, prime) pair is one block running a radix-2 butterfly NTT over N u32
// values in shared memory (8 KB at N = 2048), with host-computed twiddles and
// their Shoup companions. The result is the same function: K1 outputs equal
// the plain version mod p, K2 outputs are canonical and equal it exactly.
//
// Bound on this card: bytes. Per (row, prime) the kernel reads N inputs and
// writes N outputs once and does (N/2) log2 N butterflies of ~12 integer
// instructions, far under the ALU rate; the scattered folded-layout stores are
// what this simple design pays for. A four-step form on the int8 tensor cores
// is later work.
//
// Entry points return cudaGetLastError() of the launch.

#include "ntt_device.cuh"

using namespace tfhe;

__global__ void k1_forward(const void* __restrict__ x, int x_u64, uint32_t* __restrict__ out,
                           int logn, int logc, int nprimes, const uint32_t* __restrict__ tw,
                           const uint32_t* __restrict__ pp) {
  extern __shared__ uint32_t sh[];
  const int n = 1 << logn;
  const size_t row = blockIdx.x;
  const int pi = blockIdx.y;
  const uint32_t p = pp[pi * 4];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t v;
    if (x_u64) {
      v = (uint32_t)(((const uint64_t*)x)[row * n + i] % p);
    } else {
      long long r = (long long)((const int32_t*)x)[row * n + i] % (long long)p;
      v = (uint32_t)(r < 0 ? r + p : r);
    }
    sh[i] = v;
  }
  __syncthreads();
  const uint32_t* t = tw + (size_t)pi * 4 * n;
  ntt_fwd_rows(sh, 1, logn, t, t + n, p);
  uint32_t* o = out + (row * nprimes + pi) * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    o[folded_slot(k, logn, logc)] = sh[k];
  }
}

__global__ void k2_inverse(const uint32_t* __restrict__ f, uint32_t* __restrict__ out, int logn,
                           int logc, int nprimes, const uint32_t* __restrict__ tw,
                           const uint32_t* __restrict__ pp) {
  extern __shared__ uint32_t sh[];
  const int n = 1 << logn;
  const size_t row = blockIdx.x;
  const int pi = blockIdx.y;
  const uint32_t p = pp[pi * 4];
  const uint32_t* fi = f + (row * nprimes + pi) * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    sh[k] = fi[folded_slot(k, logn, logc)] % p;
  }
  __syncthreads();
  const uint32_t* t = tw + (size_t)pi * 4 * n;
  ntt_inv_rows(sh, 1, logn, t + 2 * n, t + 3 * n, p, pp[pi * 4 + 1], pp[pi * 4 + 2]);
  uint32_t* o = out + (row * nprimes + pi) * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    o[k] = sh[k];
  }
}

extern "C" int tfhe_ntt_forward(const void* x, int x_u64, void* out, int rows, int logn,
                                int logc, int nprimes, const void* tw, const void* pp,
                                void* stream) {
  const int n = 1 << logn;
  dim3 grid(rows, nprimes);
  k1_forward<<<grid, ntt_threads(n / 2), n * sizeof(uint32_t), (cudaStream_t)stream>>>(
      x, x_u64, (uint32_t*)out, logn, logc, nprimes, (const uint32_t*)tw, (const uint32_t*)pp);
  return (int)cudaGetLastError();
}

extern "C" int tfhe_ntt_inverse(const void* f, void* out, int rows, int logn, int logc,
                                int nprimes, const void* tw, const void* pp, void* stream) {
  const int n = 1 << logn;
  dim3 grid(rows, nprimes);
  k2_inverse<<<grid, ntt_threads(n / 2), n * sizeof(uint32_t), (cudaStream_t)stream>>>(
      (const uint32_t*)f, (uint32_t*)out, logn, logc, nprimes, (const uint32_t*)tw,
      (const uint32_t*)pp);
  return (int)cudaGetLastError();
}
