// f32 (M, K) @ posit (K, N) -> f32 (M, N), weights decoded in the kernel.
//
// Replaces the Pallas TPU kernel ``repro/kernels/posit_gemm.py``
// ``posit_gemm`` (``_gemm_kernel``): the weights stay posit patterns in
// device memory (2-4x fewer bytes than f32), each (BK, BN) weight tile
// is decoded to f32 into shared memory with the codec's ``to_f32``
// (posit.cuh, bit-identical to ``core/convert.py``), and the product
// accumulates in f32 over K.  The TPU fed the decoded tile to the MXU;
// here the multiply-adds are fp32 FMAs on the CUDA cores -- no TF32 and
// no tensor core, so the numerics stay those of an f32 matmul (the
// reference's ``jnp.dot`` at f32); only the order of the sums differs.
//
// Design: the classic shared-memory tiled SGEMM.  A block of 256
// threads computes a 64 x 64 output tile, each thread a 4 x 4 register
// micro-tile; per K step of 16 the block stages a 64 x 16 tile of A and
// a 16 x 64 tile of decoded W in shared memory.  Ragged edges are
// zero-filled on load and masked on store.
//
// Bound on the H100: fp32 operations (2 M N K at 67 TFLOP/s outside
// the tensor cores) at the smoke's shapes, or the weight bytes for a
// small M.  This simple kernel reaches a fraction of the fp32 rate; a
// faster one is later work.
//
// Plain C interface (loaded through ctypes); the entry returns the CUDA
// error code of its launch, 0 on success.
#include <cuda_runtime.h>
#include <stdint.h>

#include "posit.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

template <int N, int ES, typename P>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const float* __restrict__ a, const P* __restrict__ w, float* __restrict__ c,
            long long m_rows, long long k_len, long long n_cols) {
  __shared__ float as[kBK][kBM + 4];                 // as[k][m]
  __shared__ float ws[kBK][kBN];                     // ws[k][n], decoded
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const long long n0 = static_cast<long long>(blockIdx.y) * kBN;
  float acc[4][4] = {};
  for (long long k0 = 0; k0 < k_len; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int mm = i / kBK, kk = i % kBK;
      const long long gm = m0 + mm, gk = k0 + kk;
      as[kk][mm] = (gm < m_rows && gk < k_len) ? a[gm * k_len + gk] : 0.0f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, nn = i % kBN;
      const long long gk = k0 + kk, gn = n0 + nn;
      ws[kk][nn] = (gk < k_len && gn < n_cols)
                       ? posit::to_f32<N, ES>(static_cast<uint32_t>(w[gk * n_cols + gn]))
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gm = m0 + ty * 4 + i;
    if (gm >= m_rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long gn = n0 + tx * 4 + j;
      if (gn < n_cols) c[gm * n_cols + gn] = acc[i][j];
    }
  }
}

template <int N, int ES, typename P>
int launch(const void* a, const void* w, void* c, long long m, long long k, long long n,
           cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM),
                  static_cast<unsigned>((n + kBN - 1) / kBN));
  gemm_kernel<N, ES, P><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const P*>(w), static_cast<float*>(c), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (m, k) f32, w: (k, n) patterns, c: (m, n) f32, all contiguous.
extern "C" int posit_gemm(int nbits, int es, const void* a, const void* w, void* c,
                          long long m, long long k, long long n, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if ((m + kBM - 1) / kBM > 0x7FFFFFFFLL || (n + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbits == 32 && es == 2) return launch<32, 2, uint32_t>(a, w, c, m, k, n, s);
  if (nbits == 16 && es == 2) return launch<16, 2, uint16_t>(a, w, c, m, k, n, s);
  if (nbits == 16 && es == 1) return launch<16, 1, uint16_t>(a, w, c, m, k, n, s);
  if (nbits == 8 && es == 2) return launch<8, 2, uint8_t>(a, w, c, m, k, n, s);
  if (nbits == 8 && es == 0) return launch<8, 0, uint8_t>(a, w, c, m, k, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
