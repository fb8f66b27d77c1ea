// pgemm: posit (M, K) x posit (K, N) -> posit (M, N) through the quire.
//
// Replaces the Pallas TPU kernel ``repro/kernels/posit_qgemm.py``
// ``posit_qgemm`` (``_qgemm_kernel``): each output is one quire-lite
// reduction over K with exactly one rounding, so
// ``pgemm(a, w)[i, j] == dot(a[i], w[:, j])`` bit for bit.  The TPU
// builds a (bm, bk, bn) product lattice per grid step and carries the
// per-output quire states across a sequential K grid dimension in VMEM
// scratch; here one thread owns one output and loops over the K tiles
// itself, the state in registers.
//
// Per K tile of MAX_DOT_LENGTH = 4096 (from k = 0, folded in order,
// ragged last tile), the same two passes as posit_dot.cu: the tile's
// largest product exponent first, then every product placed against
// it and summed mod 2^128 (pvu::place_product).  Both kernels share
// pvu.cuh's quire code, so pgemm == dot holds by construction.
//
// Bound on the H100: integer operations (two decodes, a 32x32 multiply
// and a 128-bit shift and add per product, the decodes twice); each
// pattern is read by every thread of its row or column, from L1/L2.
// The design is the simple one: blocks of 16 x 16 outputs, operands
// read straight from global memory (threadIdx.x runs along N so the W
// reads coalesce and the A reads broadcast), no shared memory.
//
// Plain C interface (loaded through ctypes); the entry returns the CUDA
// error code of its launch, 0 on success.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pvu.cuh"

namespace {

constexpr int kTile = 16;

template <int N, int ES, typename P>
__global__ void qgemm_kernel(const P* __restrict__ a, const P* __restrict__ w,
                             P* __restrict__ out, long long m_rows, long long k_len,
                             long long n_cols) {
  const long long m = static_cast<long long>(blockIdx.x) * kTile + threadIdx.y;
  const long long n = static_cast<long long>(blockIdx.y) * kTile + threadIdx.x;
  if (m >= m_rows || n >= n_cols) return;
  const P* x = a + m * k_len;
  pvu::Quire s = pvu::quire_empty();
  for (long long t0 = 0; t0 < k_len; t0 += pvu::kMaxDotLength) {
    const long long t1 = t0 + pvu::kMaxDotLength < k_len ? t0 + pvu::kMaxDotLength : k_len;
    pvu::Quire t = pvu::quire_empty();
    for (long long k = t0; k < t1; ++k) {
      const pvu::Pir pa = pvu::decode<N, ES>(x[k]);
      const pvu::Pir pb = pvu::decode<N, ES>(w[k * n_cols + n]);
      const int e = pvu::product_exp(pa, pb);
      t.m_exp = e > t.m_exp ? e : t.m_exp;
      t.nar = t.nar || pa.nar || pb.nar;
    }
    for (long long k = t0; k < t1; ++k) {
      uint32_t st;
      t.acc += pvu::place_product(pvu::decode<N, ES>(x[k]),
                                  pvu::decode<N, ES>(w[k * n_cols + n]), t.m_exp, &st);
      t.sticky |= st;
    }
    s = pvu::quire_combine(s, t);
  }
  out[m * n_cols + n] = static_cast<P>(pvu::quire_finalize<N, ES>(s));
}

template <int N, int ES, typename P>
int launch(const void* a, const void* w, void* out, long long m, long long k,
           long long n, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((m + kTile - 1) / kTile),
                  static_cast<unsigned>((n + kTile - 1) / kTile));
  qgemm_kernel<N, ES, P><<<grid, dim3(kTile, kTile), 0, s>>>(
      static_cast<const P*>(a), static_cast<const P*>(w), static_cast<P*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (m, k), w: (k, n), out: (m, n), all contiguous patterns; k >= 1.
extern "C" int posit_qgemm(int nbits, int es, const void* a, const void* w, void* out,
                           long long m, long long k, long long n, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || (m + kTile - 1) / kTile > 0x7FFFFFFFLL || (n + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbits == 32 && es == 2) return launch<32, 2, uint32_t>(a, w, out, m, k, n, s);
  if (nbits == 16 && es == 2) return launch<16, 2, uint16_t>(a, w, out, m, k, n, s);
  if (nbits == 16 && es == 1) return launch<16, 1, uint16_t>(a, w, out, m, k, n, s);
  if (nbits == 8 && es == 2) return launch<8, 2, uint8_t>(a, w, out, m, k, n, s);
  if (nbits == 8 && es == 0) return launch<8, 0, uint8_t>(a, w, out, m, k, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
