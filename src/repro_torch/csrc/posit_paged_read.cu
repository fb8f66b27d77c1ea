// The chunked-prefill arena read: gather a layer's paged KV leaves through
// the chunk's virtual block table, decode the posit patterns and zero the
// slots that are not resident, in one pass.
//
// Replaces, on the serving path, the Pallas TPU kernel
// ``repro/kernels/posit_codec.py`` ``dequantize_2d`` (``_dequant_kernel``)
// inside the composite the reference computes at every chunked-prefill
// read (``repro/models/transformer.py`` ``prefill_chunk``'s ``load``:
// ``paged_gather``, ``posit_to_f32``, ``astype(cdtype)``, ``_zero_invalid``).
// One launch reads up to two jobs, the two arena leaves of one layer (K and
// V, or MLA's latent ``c_kv`` and RoPE key ``k_rope``), each (nb, bs,
// width) patterns.  Row b's virtual block vb is arena block
// ``vtables[b, vb]`` (clamped into [0, nb), as ``paged_gather`` clamps the
// sentinel); slot t = vb * bs + s is resident when
// ``low_pos[b] <= t < lens[b]``.  Output (B, Wv * bs, width) of f32 or bf16:
// ``decode(pattern)`` rounded to the output type (``__float2bfloat16_rn``)
// at resident slots, +0 elsewhere.  A block with no resident slot is
// never read, so sentinel and poisoned blocks are never touched.
//
// Bound on the H100: memory.  Every output element is written once (2 B
// bf16, 4 B f32) and every resident pattern read once (2 B posit16, 1 B
// posit8); the decode (``posit_narrow.cuh``, exact and branch-free) is a
// dozen integer operations.  The chain it replaces moved about 20 B per
// element in four launches (gather, decode to f32, cast, mask).  Design: a
// CTA per (virtual block, row, job), whose bs * width patterns are
// contiguous in the arena and whose bs * width outputs are contiguous in
// the result; 16-byte loads of patterns and 16-byte stores of results
// where every job's width is a multiple of the vector and every base is
// 16-byte aligned (the main path's widths are), a scalar loop otherwise.
//
// Plain C interface (loaded through ctypes); returns the CUDA error code of
// the launch, 0 on success.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "posit_narrow.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxJobs = 2;

struct Jobs {
  const void* arena[kMaxJobs];
  void* out[kMaxJobs];
  int width[kMaxJobs];
};

// f32 bits, or the bf16 bits of the f32 rounded to nearest even
template <typename R>
__device__ __forceinline__ R convert(float x) {
  if constexpr (sizeof(R) == 2) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  } else {
    return __float_as_uint(x);
  }
}

// P: pattern type (uint16_t posit16, uint8_t posit8); R: output bits
// (uint32_t f32, uint16_t bf16).  kVec: 16-byte vectors of patterns.
template <int N, typename P, typename R, bool kVec>
__global__ void __launch_bounds__(kThreads)
paged_read_kernel(const __grid_constant__ Jobs jobs, const int* __restrict__ vtables,
                  const long long* __restrict__ lens, const long long* __restrict__ low_pos,
                  int vwidth, int n_blocks, int bs) {
  constexpr int kVecN = 16 / static_cast<int>(sizeof(P));
  const int vb = blockIdx.x, b = blockIdx.y, j = blockIdx.z;
  const long long width = jobs.width[j];
  const long long n = bs * width;
  const long long t0 = static_cast<long long>(vb) * bs;
  R* __restrict__ out = static_cast<R*>(jobs.out[j]) +
                        (static_cast<long long>(b) * vwidth * bs + t0) * width;
  // resident slots of this block: [lo, hi) of the block's own slots
  const long long lo_t = low_pos[b] > t0 ? low_pos[b] : t0;
  const long long hi_t = lens[b] < t0 + bs ? lens[b] : t0 + bs;
  const long long lo = lo_t < hi_t ? (lo_t - t0) * width : 0;
  const long long hi = lo_t < hi_t ? (hi_t - t0) * width : 0;
  const P* __restrict__ src = nullptr;
  if (lo < hi) {
    int blk = vtables[static_cast<long long>(b) * vwidth + vb];
    blk = blk < 0 ? 0 : (blk >= n_blocks ? n_blocks - 1 : blk);
    src = static_cast<const P*>(jobs.arena[j]) + static_cast<long long>(blk) * n;
  }
  if constexpr (kVec) {
    // width % kVecN == 0, so a vector lies in one slot: lo and hi are
    // multiples of kVecN
    constexpr int kOutChunks = kVecN * static_cast<int>(sizeof(R)) / 16;
    for (long long i = static_cast<long long>(threadIdx.x) * kVecN; i < n;
         i += static_cast<long long>(kThreads) * kVecN) {
      union {
        uint4 v[kOutChunks];
        R r[kVecN];
      } res;
      if (i >= lo && i < hi) {
        union {
          uint4 v;
          P p[kVecN];
        } in;
        in.v = *reinterpret_cast<const uint4*>(src + i);
#pragma unroll
        for (int e = 0; e < kVecN; ++e)
          res.r[e] = convert<R>(posit::to_f32_narrow<N, 2>(static_cast<uint32_t>(in.p[e])));
      } else {
#pragma unroll
        for (int c = 0; c < kOutChunks; ++c) res.v[c] = make_uint4(0u, 0u, 0u, 0u);
      }
      uint4* dst = reinterpret_cast<uint4*>(out + i);
#pragma unroll
      for (int c = 0; c < kOutChunks; ++c) dst[c] = res.v[c];
    }
  } else {
    for (long long i = threadIdx.x; i < n; i += kThreads) {
      out[i] = (i >= lo && i < hi)
                   ? convert<R>(posit::to_f32_narrow<N, 2>(static_cast<uint32_t>(src[i])))
                   : R(0);
    }
  }
}

template <int N, typename P, typename R>
int launch(const Jobs& jobs, int n_jobs, const int* vtables, const long long* lens,
           const long long* low_pos, int batch, int vwidth, int n_blocks, int bs,
           cudaStream_t s) {
  constexpr int kVecN = 16 / static_cast<int>(sizeof(P));
  bool vec = true;
  for (int j = 0; j < n_jobs; ++j) {
    vec = vec && jobs.width[j] % kVecN == 0 &&
          (reinterpret_cast<uintptr_t>(jobs.arena[j]) & 15u) == 0 &&
          (reinterpret_cast<uintptr_t>(jobs.out[j]) & 15u) == 0;
  }
  const dim3 grid(static_cast<unsigned>(vwidth), static_cast<unsigned>(batch),
                  static_cast<unsigned>(n_jobs));
  if (vec) {
    paged_read_kernel<N, P, R, true><<<grid, kThreads, 0, s>>>(jobs, vtables, lens, low_pos,
                                                               vwidth, n_blocks, bs);
  } else {
    paged_read_kernel<N, P, R, false><<<grid, kThreads, 0, s>>>(jobs, vtables, lens, low_pos,
                                                                vwidth, n_blocks, bs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// nbits: 16 or 8 (es 2).  out_kind: 0 = f32, 1 = bf16.  n_jobs: 1 or 2;
// arena<j> (nb, bs, width<j>) patterns, out<j> (batch, vwidth * bs,
// width<j>); the second job's pointers are ignored when n_jobs is 1.
// vtables (batch, vwidth) int32; lens and low_pos (batch,) int64.
extern "C" int posit_paged_read(int nbits, int out_kind, int n_jobs, const void* arena0,
                                const void* arena1, void* out0, void* out1, int width0,
                                int width1, const void* vtables, const void* lens,
                                const void* low_pos, int batch, int vwidth, int n_blocks,
                                int block_size, void* stream) {
  if (batch <= 0 || vwidth <= 0) return 0;
  if (n_jobs < 1 || n_jobs > kMaxJobs || n_blocks <= 0 || block_size <= 0 || width0 <= 0 ||
      (n_jobs == 2 && width1 <= 0) || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Jobs jobs;
  jobs.arena[0] = arena0;
  jobs.arena[1] = arena1;
  jobs.out[0] = out0;
  jobs.out[1] = out1;
  jobs.width[0] = width0;
  jobs.width[1] = n_jobs == 2 ? width1 : width0;
  const int* vt = static_cast<const int*>(vtables);
  const long long* ln = static_cast<const long long*>(lens);
  const long long* lp = static_cast<const long long*>(low_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bs = block_size;
  if (nbits == 16 && out_kind == 0)
    return launch<16, uint16_t, uint32_t>(jobs, n_jobs, vt, ln, lp, batch, vwidth, n_blocks, bs, s);
  if (nbits == 16 && out_kind == 1)
    return launch<16, uint16_t, uint16_t>(jobs, n_jobs, vt, ln, lp, batch, vwidth, n_blocks, bs, s);
  if (nbits == 8 && out_kind == 0)
    return launch<8, uint8_t, uint32_t>(jobs, n_jobs, vt, ln, lp, batch, vwidth, n_blocks, bs, s);
  if (nbits == 8 && out_kind == 1)
    return launch<8, uint8_t, uint16_t>(jobs, n_jobs, vt, ln, lp, batch, vwidth, n_blocks, bs, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
