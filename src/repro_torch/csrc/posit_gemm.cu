// f32 (M, K) @ posit (K, N) -> f32 (M, N), weights decoded in the kernel.
//
// Replaces the Pallas TPU kernel ``repro/kernels/posit_gemm.py``
// ``posit_gemm`` (``_gemm_kernel``): the weights stay posit patterns in
// device memory (2-4x fewer bytes than f32), each (BK, BN) weight tile
// is decoded to f32 into shared memory once (``to_f32_narrow`` for
// posit8/16, exact without rounding; the codec's ``to_f32`` for posit32;
// both bit-identical to ``core/convert.py``), and the product
// accumulates in f32 over K.  The TPU fed the decoded tile to the MXU;
// here the multiply-adds are fp32 FMAs on the CUDA cores -- no TF32 and
// no tensor core, so the numerics stay those of an f32 matmul (the
// reference's ``jnp.dot`` at f32); only the order of the sums differs.
//
// Bound on the H100: fp32 operations, 2 M N K at 67 TFLOP/s outside the
// tensor cores (the weight bytes only for a small M).  Near it the FMA
// pipes issue almost every cycle, so the design keeps everything else
// off the K loop:
//
// - Tiles.  A CTA of 256 threads computes a 128 x BN output tile (BN 128,
//   or 64 when N <= 64, as in the paper's conv), each thread an 8 x 8
//   (8 x 4) register micro-tile: rows ty*4 + i and 64 + ty*4 + i,
//   columns tx*4 + j and BN/2 + tx*4 + j, so every shared-memory read
//   is a 16-byte LDS.128 and a warp's reads hit no bank twice.  Per K
//   step that is 64 FMAs per 4 LDS.128; the next step's fragments are
//   read during the current step's FMAs.  A is stored k-major in shared
//   memory (As[k][m]), W decoded and row-major (Ws[k][n]).  At 128
//   registers two CTAs share an SM.
// - Loads and decode.  Per K tile of 16 each thread reads two 16-byte
//   vectors of A (scalars where K or the base is not 16-byte aligned:
//   the conv's K = 147) into registers, and copies its run of 8 (4)
//   weight patterns with ``cp.async`` into a raw staging tile, which it
//   alone reads back, decodes once and stores as f32.  With M <= 128 in
//   one block row no weight is decoded twice.  The vector and scalar
//   paths are separate instantiations, so the K loop carries no
//   alignment branches, and only a ragged last tile checks K.
// - Double buffering.  Tile k+1's loads and copies are in flight while
//   tile k's FMAs run; they are stored (decoded) into the other
//   shared-memory stage after them: one barrier per K tile.
// - Waves.  An MLP-sized N / 128 (140 tiles at phi3's 17 920) on 132 SMs
//   would leave a second wave of 8 tiles.  The wrapper picks a split of
//   K (grid z) from the SM count (``gemm_plan``); each split writes its
//   own f32 partial product and a second kernel sums the partials in
//   split order.  No atomics: two calls give identical bits.
// - Edges.  Ragged M, N and K are zero-filled on load and masked on
//   store, inside the kernel.
//
// Plain C interface (loaded through ctypes); the entry returns the CUDA
// error code of its launches, 0 on success.
#include <cuda_runtime.h>
#include <stdint.h>

#include "posit.cuh"
#include "posit_narrow.cuh"

namespace {

constexpr int kBM = 128, kBK = 16, kThreads = 256;
constexpr int kMinBlocks = 2;   // CTAs resident per SM: 128 registers a thread

template <int N, int ES>
__device__ __forceinline__ float decode(uint32_t p) {
  if constexpr (N <= 16) {
    return posit::to_f32_narrow<N, ES>(p);
  } else {
    return posit::to_f32<N, ES>(p);
  }
}

// TW consecutive patterns of one weight row from an aligned address, one
// per register.
template <typename P, int TW>
__device__ __forceinline__ void load_run(const P* src, uint32_t (&dst)[TW]) {
  constexpr int kBytes = TW * static_cast<int>(sizeof(P));
  constexpr int kWords = kBytes / 4;
  uint32_t u[kWords];
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[i];
      u[4 * i] = v.x; u[4 * i + 1] = v.y; u[4 * i + 2] = v.z; u[4 * i + 3] = v.w;
    }
  } else if constexpr (kBytes == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    u[0] = v.x; u[1] = v.y;
  } else {
    u[0] = *reinterpret_cast<const uint32_t*>(src);
  }
  constexpr int kPer = 4 / static_cast<int>(sizeof(P));   // patterns per word
  constexpr uint32_t kMask = sizeof(P) == 4 ? 0xFFFFFFFFu : ((1u << (8 * sizeof(P))) - 1u);
#pragma unroll
  for (int i = 0; i < TW; ++i)
    dst[i] = (u[i / kPer] >> (8 * sizeof(P) * (i % kPer))) & kMask;
}

// cp.async of B bytes (4, 8, 16 or 32), zero-filled when !full.
template <int B>
__device__ __forceinline__ void cp_async_run(void* smem, const void* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (B == 32) {
    const int src = full ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s + 16),
                 "l"(static_cast<const char*>(gmem) + 16), "r"(src));
  } else {
    const int src = full ? B : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem), "n"(B),
                 "r"(src));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// VA: A rows read as 16-byte vectors (K % 4 == 0, aligned); VW: weight
// runs copied as vectors (N % TW == 0, aligned).  Otherwise scalars.
template <int N, int ES, typename P, int BN, bool VA, bool VW>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gemm_kernel(const float* __restrict__ a, const P* __restrict__ w, float* __restrict__ c,
            float* __restrict__ part, long long m_rows, long long k_len, long long n_cols,
            long long k_split) {
  constexpr int TN = BN / 16;                     // columns per thread: 8 or 4
  constexpr int TW = kBK * BN / kThreads;         // weights per thread per tile
  constexpr int kWCols = BN / TW;                 // threads per weight row
  constexpr int kAV = kBM * kBK / 4 / kThreads;   // A float4s per thread
  constexpr int kAS = kBM * kBK / kThreads;       // A scalars per thread
  constexpr int kKQ = kBK / 4;                    // float4s per A tile row
  constexpr int kWBytes = TW * static_cast<int>(sizeof(P));
  static_assert(TW % 4 == 0 && kWBytes >= 4, "a thread's weight run: whole float4s, >= 4 bytes");
  __shared__ __align__(16) float As[2][kBK][kBM + 4];   // As[k][m]
  __shared__ __align__(16) float Ws[2][kBK][BN];        // Ws[k][n], decoded
  __shared__ __align__(16) P Wr[kBK][BN];               // raw patterns in flight

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const long long n0 = static_cast<long long>(blockIdx.y) * BN;
  const long long k_begin = static_cast<long long>(blockIdx.z) * k_split;
  const long long k_end = k_begin + k_split < k_len ? k_begin + k_split : k_len;
  const int nk = static_cast<int>((k_end - k_begin + kBK - 1) / kBK);

  // this thread's share of a tile's loads.  A: float4 j of the tile is
  // row a_row + j * kRowsV at k a_k .. a_k + 3 (VA), scalar j row
  // a_row + j * kRowsS at k a_k; W: row wk, columns wn .. wn + TW - 1.
  // Pointers advance one tile per step; only a ragged last tile checks k.
  constexpr int kRowsV = kThreads / kKQ, kRowsS = kThreads / kBK;
  const int a_row = VA ? tid / kKQ : tid / kBK;
  const int a_k = VA ? (tid % kKQ) * 4 : tid % kBK;
  const int m_left = m_rows - m0 < kBM ? static_cast<int>(m_rows - m0) : kBM;
  const float* a_cur = a + (m0 + a_row) * k_len + k_begin + a_k;
  const long long a_jump = static_cast<long long>(VA ? kRowsV : kRowsS) * k_len;
  const int wk = tid / kWCols, wn = (tid % kWCols) * TW;
  const int n_left = n_cols - n0 < BN ? static_cast<int>(n_cols - n0) : BN;
  const P* w_cur = w + (k_begin + wk) * n_cols + n0 + wn;
  const long long w_jump = static_cast<long long>(kBK) * n_cols;
  float a_reg[VA ? 4 * kAV : kAS];

  auto k_left = [&](long long k0) {
    return k_end - k0 < kBK ? static_cast<int>(k_end - k0) : kBK;
  };
  auto load_tile = [&](long long k0) {
    const int kl = k_left(k0);
    if constexpr (VA) {
#pragma unroll
      for (int j = 0; j < kAV; ++j) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (a_k < kl && a_row + j * kRowsV < m_left)
          v = *reinterpret_cast<const float4*>(a_cur + j * a_jump);
        a_reg[4 * j] = v.x; a_reg[4 * j + 1] = v.y; a_reg[4 * j + 2] = v.z; a_reg[4 * j + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kAS; ++j)
        a_reg[j] = (a_k < kl && a_row + j * kRowsS < m_left) ? a_cur[j * a_jump] : 0.f;
    }
    if constexpr (VW) {  // this thread's TW patterns, in flight into Wr (zeros off the edge)
      const bool in = wn < n_left && wk < kl;
      cp_async_run<kWBytes>(&Wr[wk][wn], in ? w_cur : w, in);
      cp_async_commit();
    }
  };
  auto store_tile = [&](int buf, long long k0) {
    if constexpr (VA) {
#pragma unroll
      for (int j = 0; j < kAV; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) As[buf][a_k + i][a_row + j * kRowsV] = a_reg[4 * j + i];
    } else {
#pragma unroll
      for (int j = 0; j < kAS; ++j) As[buf][a_k][a_row + j * kRowsS] = a_reg[j];
    }
    uint32_t w_reg[TW];
    if constexpr (VW) {  // the thread's own copies: no barrier needed
      cp_async_wait_all();
      load_run<P, TW>(&Wr[wk][wn], w_reg);
    } else {             // scalar edge path, loaded here
      const bool k_ok = wk < k_left(k0);
#pragma unroll
      for (int i = 0; i < TW; ++i)
        w_reg[i] = (k_ok && wn + i < n_left) ? static_cast<uint32_t>(w_cur[i]) : 0u;
    }
#pragma unroll
    for (int i = 0; i < TW; i += 4) {
      *reinterpret_cast<float4*>(&Ws[buf][wk][wn + i]) =
          make_float4(decode<N, ES>(w_reg[i]), decode<N, ES>(w_reg[i + 1]),
                      decode<N, ES>(w_reg[i + 2]), decode<N, ES>(w_reg[i + 3]));
    }
    a_cur += kBK;
    w_cur += w_jump;
  };
  // one K step's fragments: 8 rows of A, TN columns of W, LDS.128 each
  auto load_frag = [&](int buf, int kk, float (&av)[8], float (&bv)[TN]) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
    av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
    av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
    const float4 b0 = *reinterpret_cast<const float4*>(&Ws[buf][kk][tx * 4]);
    bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
    if constexpr (TN == 8) {
      const float4 b1 = *reinterpret_cast<const float4*>(&Ws[buf][kk][BN / 2 + tx * 4]);
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (nk > 0) {
    load_tile(k_begin);
    store_tile(0, k_begin);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const long long k_next = k_begin + static_cast<long long>(kt + 1) * kBK;
    if (kt + 1 < nk) load_tile(k_next);
    // fragments double-buffered in registers: step kk + 1's shared
    // loads are in flight during step kk's FMAs
    float av[2][8], bv[2][TN];
    load_frag(cur, 0, av[0], bv[0]);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      if (kk + 1 < kBK) load_frag(cur, kk + 1, av[(kk + 1) & 1], bv[(kk + 1) & 1]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[kk & 1][i], bv[kk & 1][j], acc[i][j]);
    }
    if (kt + 1 < nk) store_tile(cur ^ 1, k_next);
    __syncthreads();
  }

  float* out = gridDim.z == 1 ? c : part + static_cast<long long>(blockIdx.z) * m_rows * n_cols;
  const bool vec_c = n_cols % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gm >= m_rows) continue;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const long long gn = n0 + h * (BN / 2) + tx * 4;
      float* dst = out + gm * n_cols + gn;
      if (vec_c && gn < n_cols) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else if (!vec_c) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < n_cols) dst[j] = acc[i][4 * h + j];
      }
    }
  }
}

// c = sum over z of part[z], in the order z = 0, 1, ..., splits - 1.
__global__ void __launch_bounds__(kThreads)
split_sum_kernel(const float* __restrict__ part, float* __restrict__ c, long long n, int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  if (n % 4 == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(part);
    float4* c4 = reinterpret_cast<float4*>(c);
    const long long n4 = n / 4;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n4;
         i += stride) {
      float4 s = p4[i];
      for (int z = 1; z < splits; ++z) {
        const float4 v = p4[z * n4 + i];
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
      c4[i] = s;
    }
  } else {
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
         i += stride) {
      float s = part[i];
      for (int z = 1; z < splits; ++z) s += part[z * n + i];
      c[i] = s;
    }
  }
}

template <int N, int ES, typename P, int BN>
int launch(const void* a, const void* w, void* c, void* part, long long m, long long k,
           long long n, int splits, cudaStream_t s) {
  constexpr int TW = kBK * BN / kThreads;
  constexpr int kWBytes = TW * static_cast<int>(sizeof(P));
  const long long m_tiles = (m + kBM - 1) / kBM, n_tiles = (n + BN - 1) / BN;
  if (m_tiles > 0x7FFFFFFFLL || n_tiles > 65535 || splits < 1 || splits > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  // K per split: whole K tiles, so every split but the last is full
  const long long k_tiles = (k + kBK - 1) / kBK;
  const long long k_split = ((k_tiles + splits - 1) / splits) * kBK;
  const int used = k > 0 ? static_cast<int>((k + k_split - 1) / k_split) : 1;
  const bool vec_w = n % TW == 0 &&
                     reinterpret_cast<uintptr_t>(w) % (kWBytes < 16 ? kWBytes : 16) == 0;
  const bool vec_a = vec_w && k % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(m_tiles), static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>(used));
  const float* af = static_cast<const float*>(a);
  const P* wp = static_cast<const P*>(w);
  float* cf = static_cast<float*>(c);
  float* pf = static_cast<float*>(part);
  const long long ks = k_split > 0 ? k_split : kBK;
  if (vec_a)
    gemm_kernel<N, ES, P, BN, true, true><<<grid, kThreads, 0, s>>>(af, wp, cf, pf, m, k, n, ks);
  else if (vec_w)
    gemm_kernel<N, ES, P, BN, false, true><<<grid, kThreads, 0, s>>>(af, wp, cf, pf, m, k, n, ks);
  else
    gemm_kernel<N, ES, P, BN, false, false><<<grid, kThreads, 0, s>>>(af, wp, cf, pf, m, k, n, ks);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || used == 1) return rc;
  const long long total = m * n;
  long long blocks = ((total % 4 == 0 ? total / 4 : total) + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) blocks = 0x7FFFFFFFLL;  // the rest by the grid-stride loop
  split_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(c), total, used);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int ES, typename P>
int dispatch(const void* a, const void* w, void* c, void* part, long long m, long long k,
             long long n, int bn, int splits, cudaStream_t s) {
  if (bn == 64) return launch<N, ES, P, 64>(a, w, c, part, m, k, n, splits, s);
  if (bn == 128) return launch<N, ES, P, 128>(a, w, c, part, m, k, n, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// a: (m, k) f32, w: (k, n) patterns, c: (m, n) f32, all contiguous.
// bn: the tile width, 64 or 128.  splits: the number of K splits asked
// for (the kernel uses ceil(k / (ceil(ceil(k/16) / splits) * 16)) of
// them); with more than one, part holds that many (m, n) f32 partials.
extern "C" int posit_gemm(int nbits, int es, const void* a, const void* w, void* c,
                          void* part, long long m, long long k, long long n, int bn,
                          int splits, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbits == 32 && es == 2) return dispatch<32, 2, uint32_t>(a, w, c, part, m, k, n, bn, splits, s);
  if (nbits == 16 && es == 2) return dispatch<16, 2, uint16_t>(a, w, c, part, m, k, n, bn, splits, s);
  if (nbits == 16 && es == 1) return dispatch<16, 1, uint16_t>(a, w, c, part, m, k, n, bn, splits, s);
  if (nbits == 8 && es == 2) return dispatch<8, 2, uint8_t>(a, w, c, part, m, k, n, bn, splits, s);
  if (nbits == 8 && es == 0) return dispatch<8, 0, uint8_t>(a, w, c, part, m, k, n, bn, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
