// pgemm: posit (M, K) x posit (K, N) -> posit (M, N) through the quire.
//
// Replaces the Pallas TPU kernel ``repro/kernels/posit_qgemm.py``
// ``posit_qgemm`` (``_qgemm_kernel``): each output is one quire-lite
// reduction over K with exactly one rounding, so
// ``pgemm(a, w)[i, j] == dot(a[i], w[:, j])`` bit for bit.  The TPU
// builds a (bm, bk, bn) product lattice per grid step and carries the
// per-output quire states across a sequential K grid dimension in VMEM
// scratch.
//
// The quire (pvu.cuh, shared with posit_dot.cu): per K tile of
// MAX_DOT_LENGTH = 4096 (from k = 0, ragged last tile), an exponent pass
// takes the tile's largest product exponent per output, a placing pass
// aligns every product to it and sums mod 2^128 (pvu::place_add);
// tile states fold in tile order from k = 0 (pvu::quire_combine) and
// round once (pvu::quire_finalize).  Tiles are independent until the
// fold, so they run in parallel here: grid.z is the tile, each CTA
// writes its outputs' tile states (acc, m_exp, sticky, NaR) to a
// workspace, and a second kernel folds them in tile order and finalizes.
// The states and the fold are the sequential loop's, so the result is.
// A single-tile K finalizes in the first kernel.
//
// Bound on the H100: integer operations, 14 a product (a 32x32 multiply,
// the 128-bit placement, a conditional negate, a 128-bit add): 0.192 ms
// for the paper's conv (95 048 x 147 x 64) and 0.307 ms at a phi3-width
// posit-exact linear (16 x 17 920 x 5 120) at 67 T ops/s.  Design:
//   - a CTA owns 16 x 64 outputs and one K tile, 256 threads, each 2 x 2
//     outputs in registers (rows ty, ty + 8; columns tx, tx + 32), so a
//     decoded operand serves two products;
//   - K sub-tiles of 32 are loaded by the whole CTA (the next one into
//     registers while the current one is computed, which takes any
//     alignment and a ragged K; cp.async has no 2-byte form and the
//     conv's A rows are 588 B apart) and decoded once per CTA per pass
//     into shared memory: the exponent pass keeps only the exponent (a
//     zero operand as kZeroExp) and row/column NaR flags, the placing
//     pass the significand and (exponent << 1 | sign);
//   - the exponent pass is the exact per-output maximum over the tile
//     (an upper bound would move the quire window); padding outside M, N
//     and K is the zero pattern, which never changes a state;
//   - the placing pass is pvu::place_add: funnel shifts and selects on
//     32-bit words, no branch, and for posit16 and posit8 a 16 x 16-bit
//     product (their significands' low 16 bits are zero).
//
// Plain C interface (loaded through ctypes); the entry returns the CUDA
// error code of its launch, 0 on success.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pvu.cuh"

namespace {

constexpr int kBM = 16;                 // outputs per CTA along M
constexpr int kBN = 64;                 // along N
constexpr int kBK = 32;                 // K sub-tile staged in shared memory
constexpr int kThreads = 256;           // 8 (ty) x 32 (tx)
constexpr int kLoadA = kBM * kBK / kThreads;   // patterns a thread loads
constexpr int kLoadW = kBK * kBN / kThreads;
// a zero operand's exponent in the max pass: any sum with it lies below
// -(1 << 28) and every product of two nonzero operands above it
constexpr int kZeroExp = -(1 << 29);

static_assert(sizeof(pvu::Quire) == 32, "workspace layout: 32 B a state");

struct Smem {
  uint32_t sig_a[kBK][kBM];   // placing pass: place_sig (0 for zero, NaR)
  uint32_t sig_w[kBK][kBN];
  int meta_a[kBK][kBM];       // exponent pass: exponent or kZeroExp;
  int meta_w[kBK][kBN];       // placing pass: exponent << 1 | sign
  int nar_a[kBM];             // a NaR in the tile's row / column
  int nar_w[kBN];
};

template <typename P>
__device__ __forceinline__ void load_sub(const P* __restrict__ a, const P* __restrict__ w,
                                         long long m0, long long n0, long long k0, long long k1,
                                         long long m_rows, long long k_len, long long n_cols,
                                         uint32_t (&ra)[kLoadA], uint32_t (&rw)[kLoadW]) {
#pragma unroll
  for (int r = 0; r < kLoadA; ++r) {
    const int e = threadIdx.x + r * kThreads;
    const long long m = m0 + e / kBK, k = k0 + e % kBK;
    ra[r] = (m < m_rows && k < k1) ? static_cast<uint32_t>(a[m * k_len + k]) : 0u;
  }
#pragma unroll
  for (int r = 0; r < kLoadW; ++r) {
    const int e = threadIdx.x + r * kThreads;
    const long long k = k0 + e / kBN, n = n0 + e % kBN;
    rw[r] = (n < n_cols && k < k1) ? static_cast<uint32_t>(w[k * n_cols + n]) : 0u;
  }
}

// Decode the staged patterns into shared memory: pass 0 the exponent
// (and NaR flags), pass 1 the significand and exponent << 1 | sign.
template <int N, int ES, int kPass>
__device__ __forceinline__ void decode_sub(Smem& s, const uint32_t (&ra)[kLoadA],
                                           const uint32_t (&rw)[kLoadW]) {
#pragma unroll
  for (int r = 0; r < kLoadA; ++r) {
    const int e = threadIdx.x + r * kThreads;
    const pvu::Pir p = pvu::decode<N, ES>(ra[r]);
    if (kPass == 0) {
      s.meta_a[e % kBK][e / kBK] = p.zero ? kZeroExp : p.exp;
      if (p.nar) s.nar_a[e / kBK] = 1;
    } else {
      s.sig_a[e % kBK][e / kBK] = pvu::place_sig<(N <= 16)>(p.sig);
      s.meta_a[e % kBK][e / kBK] = (p.exp << 1) | static_cast<int>(p.sign);
    }
  }
#pragma unroll
  for (int r = 0; r < kLoadW; ++r) {
    const int e = threadIdx.x + r * kThreads;
    const pvu::Pir p = pvu::decode<N, ES>(rw[r]);
    if (kPass == 0) {
      s.meta_w[e / kBN][e % kBN] = p.zero ? kZeroExp : p.exp;
      if (p.nar) s.nar_w[e % kBN] = 1;
    } else {
      s.sig_w[e / kBN][e % kBN] = pvu::place_sig<(N <= 16)>(p.sig);
      s.meta_w[e / kBN][e % kBN] = (p.exp << 1) | static_cast<int>(p.sign);
    }
  }
}

// two CTAs an SM: at most 128 registers a thread (unbounded, the compiler
// takes about 150 and one CTA fits, which measured slower)
template <int N, int ES, typename P>
__global__ void __launch_bounds__(kThreads, 2)
qgemm_tile_kernel(const P* __restrict__ a, const P* __restrict__ w, P* __restrict__ out,
                  pvu::Quire* __restrict__ ws, long long m_rows, long long k_len,
                  long long n_cols) {
  __shared__ Smem s;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const long long n0 = static_cast<long long>(blockIdx.y) * kBN;
  const long long t0 = static_cast<long long>(blockIdx.z) * pvu::kMaxDotLength;
  const long long t1 = t0 + pvu::kMaxDotLength < k_len ? t0 + pvu::kMaxDotLength : k_len;
  const int n_sub = static_cast<int>((t1 - t0 + kBK - 1) / kBK);
  if (threadIdx.x < kBM) s.nar_a[threadIdx.x] = 0;
  if (threadIdx.x < kBN) s.nar_w[threadIdx.x] = 0;

  uint32_t ra[kLoadA], rw[kLoadW];
  int mexp[2][2];
  pvu::TileSum sum[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mexp[i][j] = 2 * kZeroExp;
      sum[i][j] = pvu::tile_sum_empty();
    }

  // pass 0: the exact largest product exponent of the tile per output
  load_sub(a, w, m0, n0, t0, t1, m_rows, k_len, n_cols, ra, rw);
  for (int sub = 0; sub < n_sub; ++sub) {
    __syncthreads();                    // the previous sub-tile is consumed
    decode_sub<N, ES, 0>(s, ra, rw);
    if (sub + 1 < n_sub)
      load_sub(a, w, m0, n0, t0 + (sub + 1) * kBK, t1, m_rows, k_len, n_cols, ra, rw);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const int ea[2] = {s.meta_a[kk][ty], s.meta_a[kk][ty + 8]};
      const int ew[2] = {s.meta_w[kk][tx], s.meta_w[kk][tx + 32]};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) mexp[i][j] = max(mexp[i][j], ea[i] + ew[j]);
    }
  }
  bool nar[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // any sum with a zero operand stands for pvu::product_exp's sentinel
      if (mexp[i][j] < -(1 << 28)) mexp[i][j] = pvu::kExpSentinel;
      nar[i][j] = s.nar_a[ty + 8 * i] != 0 || s.nar_w[tx + 32 * j] != 0;
    }

  // pass 1: every product placed against its output's exponent
  load_sub(a, w, m0, n0, t0, t1, m_rows, k_len, n_cols, ra, rw);
  for (int sub = 0; sub < n_sub; ++sub) {
    __syncthreads();
    decode_sub<N, ES, 1>(s, ra, rw);
    if (sub + 1 < n_sub)
      load_sub(a, w, m0, n0, t0 + (sub + 1) * kBK, t1, m_rows, k_len, n_cols, ra, rw);
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kBK; ++kk) {
      // significand 0 (zero, NaR) places nothing; NaR is in the flags
      const uint32_t sa[2] = {s.sig_a[kk][ty], s.sig_a[kk][ty + 8]};
      const uint32_t sw[2] = {s.sig_w[kk][tx], s.sig_w[kk][tx + 32]};
      const int ma[2] = {s.meta_a[kk][ty], s.meta_a[kk][ty + 8]};
      const int mw[2] = {s.meta_w[kk][tx], s.meta_w[kk][tx + 32]};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          pvu::place_add<(N <= 16)>(&sum[i][j], sa[i], sw[j],
                                    mexp[i][j] - ((ma[i] >> 1) + (mw[j] >> 1)),
                                    static_cast<uint32_t>(ma[i] ^ mw[j]) & 1u);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long m = m0 + ty + 8 * i, n = n0 + tx + 32 * j;
      if (m >= m_rows || n >= n_cols) continue;
      pvu::Quire t;
      t.acc = sum[i][j].acc + sum[i][j].ones;
      t.m_exp = mexp[i][j];
      t.sticky = sum[i][j].sticky;
      t.nar = nar[i][j];
      if (gridDim.z == 1) {
        out[m * n_cols + n] = static_cast<P>(
            pvu::quire_finalize<N, ES>(pvu::quire_combine(pvu::quire_empty(), t)));
      } else {
        ws[(static_cast<long long>(blockIdx.z) * m_rows + m) * n_cols + n] = t;
      }
    }
}

// The fold: a thread per output, tile states combined in tile order from
// k = 0, one rounding.
template <int N, int ES, typename P>
__global__ void qgemm_fold_kernel(const pvu::Quire* __restrict__ ws, P* __restrict__ out,
                                  long long mn, int n_tiles) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  pvu::Quire s = pvu::quire_empty();
  for (int t = 0; t < n_tiles; ++t) s = pvu::quire_combine(s, ws[t * mn + i]);
  out[i] = static_cast<P>(pvu::quire_finalize<N, ES>(s));
}

template <int N, int ES, typename P>
int launch(const void* a, const void* w, void* out, void* ws, long long m, long long k,
           long long n, cudaStream_t s) {
  const long long n_tiles = (k + pvu::kMaxDotLength - 1) / pvu::kMaxDotLength;
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM),
                  static_cast<unsigned>((n + kBN - 1) / kBN), static_cast<unsigned>(n_tiles));
  qgemm_tile_kernel<N, ES, P><<<grid, kThreads, 0, s>>>(
      static_cast<const P*>(a), static_cast<const P*>(w), static_cast<P*>(out),
      static_cast<pvu::Quire*>(ws), m, k, n);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || n_tiles == 1) return rc;
  const long long mn = m * n;
  qgemm_fold_kernel<N, ES, P><<<static_cast<unsigned>((mn + 255) / 256), 256, 0, s>>>(
      static_cast<const pvu::Quire*>(ws), static_cast<P*>(out), mn, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Workspace bytes one call needs: the tile states of a multi-tile K.
extern "C" long long posit_qgemm_workspace_bytes(long long m, long long k, long long n) {
  const long long n_tiles = (k + pvu::kMaxDotLength - 1) / pvu::kMaxDotLength;
  return n_tiles > 1 ? n_tiles * m * n * static_cast<long long>(sizeof(pvu::Quire)) : 0;
}

// a: (m, k), w: (k, n), out: (m, n), all contiguous patterns; k >= 1.
// ws: posit_qgemm_workspace_bytes(m, k, n) bytes of device memory, 16-byte
// aligned (unused, may be null, when k <= 4096); ws_bytes: its size.
extern "C" int posit_qgemm(int nbits, int es, const void* a, const void* w, void* out, void* ws,
                           long long ws_bytes, long long m, long long k, long long n,
                           void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || (m + kBM - 1) / kBM > 0x7FFFFFFFLL || (n + kBN - 1) / kBN > 65535 ||
      (k + pvu::kMaxDotLength - 1) / pvu::kMaxDotLength > 65535 ||
      ws_bytes < posit_qgemm_workspace_bytes(m, k, n) ||
      (reinterpret_cast<uintptr_t>(ws) & 15u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbits == 32 && es == 2) return launch<32, 2, uint32_t>(a, w, out, ws, m, k, n, s);
  if (nbits == 16 && es == 2) return launch<16, 2, uint16_t>(a, w, out, ws, m, k, n, s);
  if (nbits == 16 && es == 1) return launch<16, 1, uint16_t>(a, w, out, ws, m, k, n, s);
  if (nbits == 8 && es == 2) return launch<8, 2, uint8_t>(a, w, out, ws, m, k, n, s);
  if (nbits == 8 && es == 0) return launch<8, 0, uint8_t>(a, w, out, ws, m, k, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
