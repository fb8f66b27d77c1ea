// The pieces shared by the split paged-decode kernels (``paged_attn.cu``,
// ``paged_attn_mla.cu``): the arena pattern decoders, the ``cp.async``
// copies and warp reductions of the split CTAs, and the fold.
//
// A split CTA walks a run of a row's block table and leaves its online-
// softmax state per query head: acc (Dv floats, not normalised) in
// ``part_acc`` as (rows, S, Dv) and (m, l) in ``part_ml`` as (rows, S, 2).
// The fold combines a head's S splits in split order (deterministic):
// split s weighs exp(m_s - max m), a split with l == 0 (no valid slot)
// weighs 0 whatever its m and its acc is never read, and the output is
// acc / max(l, 1e-30), so a head with no valid slot anywhere comes out as
// exact zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "posit_narrow.cuh"

namespace paged_split {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;

// Each decoder turns one 16-byte vector of patterns into kVec floats.
struct DecF32 {
  using T = float;
  static constexpr int kVec = 4;
  static __device__ __forceinline__ float get(T v) { return v; }
  static __device__ __forceinline__ void vec(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
};
struct DecBF16 {
  using T = __nv_bfloat16;
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float get(T v) { return __bfloat162float(v); }
  static __device__ __forceinline__ void vec(uint4 u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};
struct DecPosit16 {
  using T = uint16_t;
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float get(T v) { return posit::to_f32_narrow<16, 2>(v); }
  static __device__ __forceinline__ void vec(uint4 u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = posit::to_f32_narrow<16, 2>(w[i] & 0xFFFFu);
      f[2 * i + 1] = posit::to_f32_narrow<16, 2>(w[i] >> 16);
    }
  }
};
struct DecPosit8 {
  using T = uint8_t;
  static constexpr int kVec = 16;
  static __device__ __forceinline__ float get(T v) { return posit::to_f32_narrow<8, 2>(v); }
  static __device__ __forceinline__ void vec(uint4 u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f[4 * i + j] = posit::to_f32_narrow<8, 2>((w[i] >> (8 * j)) & 0xFFu);
  }
};

// 16-byte asynchronous global -> shared copies (the next block's
// patterns, in flight while the current one is decoded and scored).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

// A thread per (row, column of acc): the S partials folded in split
// order.  Each thread finds the row's max m over live splits and sums
// the weighted l in split order itself (the row's (m, l) pairs are read
// by every thread of the CTA, from L1), then walks the splits' column
// values, their loads independent of the FMA chain so several are in
// flight at once.
__global__ void __launch_bounds__(kThreads)
fold_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
            float* __restrict__ out, int n_split, int Dv) {
  const long long row = blockIdx.x;
  const int d = blockIdx.y * kThreads + threadIdx.x;
  if (d >= Dv) return;
  const float* ml = part_ml + row * n_split * 2;
  float mx = kNeg;
  for (int s = 0; s < n_split; ++s)
    if (ml[2 * s + 1] > 0.f) mx = fmaxf(mx, ml[2 * s]);
  float l = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float ls = ml[2 * s + 1];
    l += ls > 0.f ? ls * expf(ml[2 * s] - mx) : 0.f;
  }
  const float* pa = part_acc + row * n_split * Dv + d;
  float a = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {
    const float v = pa[(long long)s * Dv];
    const float wt = ml[2 * s + 1] > 0.f ? expf(ml[2 * s] - mx) : 0.f;
    if (wt != 0.f) a = fmaf(v, wt, a);
  }
  out[row * Dv + d] = a / fmaxf(l, 1e-30f);
}

// Launch the fold of ``rows`` heads' S partials into out (rows, Dv);
// returns the launch's CUDA error code.
inline int fold(const float* part_acc, const float* part_ml, float* out, long long rows,
                int n_split, int Dv, cudaStream_t s) {
  if (rows > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>((Dv + kThreads - 1) / kThreads));
  fold_kernel<<<grid, kThreads, 0, s>>>(part_acc, part_ml, out, n_split, Dv);
  return static_cast<int>(cudaGetLastError());
}

// Opt a kernel in to ``bytes`` of dynamic shared memory past the
// default 48 KB, once per device: ``granted`` is the caller's record for
// this kernel (a static of its launch function, which has internal
// linkage, so no other kernel or library shares it).
template <class K>
inline cudaError_t allow_smem(K kernel, size_t bytes, size_t (&granted)[64]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && granted[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess && dev < 64) granted[dev] = bytes;
  return e;
}

}  // namespace paged_split
