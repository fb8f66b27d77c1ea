// Fused paged-decode attention: one query token per row against the
// row's block-table KV, posit K/V decoded in-kernel.
//
// Replaces the Pallas TPU kernel ``repro/kernels/posit_paged_attn.py``
// ``paged_decode_attention`` (``_paged_attn_kernel``).  Same inputs and
// result: q (B, G, R, D) f32 pre-scaled by D**-0.5; arenas (nb, bs, G, D)
// and (nb, bs, G, Dv) as posit16 / posit8 patterns, f32 or bf16; tables
// (B, W) int32 with the sentinel nb; apos (B, W*bs) int32 (-1 = dead);
// lens (B,) int32 -> out (B, G, R, Dv) f32.
//
// The TPU kernel walks W as a sequential grid axis and carries the
// online-softmax state in VMEM scratch.  Blocks on Hopper run in no
// order, so the walk is a loop inside one CTA per (row b, KV head g),
// which holds all R = H/G query heads of that KV head.  Each step reads
// tables[b, w] itself and skips a sentinel block without loading it
// (its slots are all invalid, so the TPU kernel's update is the identity
// there too); otherwise it decodes the bs x D posit K and V patterns to
// f32 in shared memory, scores them against q, and folds them into the
// running max m, denominator l and accumulator acc, all f32.  Invalid
// slots get p = 0 (not exp(-1e30 - m)), so a row with no valid slot
// keeps l == 0 and its output is acc / max(l, 1e-30) = exact zeros.
//
// Bound on the H100: memory -- the K/V patterns of the row's live
// blocks, read once (posit16: 2 B x (D + Dv) per slot and KV head).
// This first version is simple rather than fast: one CTA per (b, g),
// plain fp32 FMAs, no tensor cores, no TMA, no split over W.
//
// Plain C interface (loaded through ctypes); returns the CUDA error code
// of the launch, 0 on success.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "posit.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;
constexpr int kMaxSmem = 48 * 1024;

struct DecF32 {
  using T = float;
  static __device__ __forceinline__ float get(T v) { return v; }
};
struct DecBF16 {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float get(T v) { return __bfloat162float(v); }
};
struct DecPosit16 {
  using T = uint16_t;
  static __device__ __forceinline__ float get(T v) { return posit::to_f32<16, 2>(v); }
};
struct DecPosit8 {
  using T = uint8_t;
  static __device__ __forceinline__ float get(T v) { return posit::to_f32<8, 2>(v); }
};

size_t smem_bytes(int R, int D, int Dv, int bs) {
  const size_t floats = (size_t)R * D + (size_t)bs * (D + 1) + (size_t)bs * Dv +
                        (size_t)R * bs + (size_t)R * Dv + 3 * (size_t)R;
  return floats * sizeof(float) + (size_t)bs * sizeof(int);
}

template <class Dec>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const float* __restrict__ q, const typename Dec::T* __restrict__ k_arena,
                  const typename Dec::T* __restrict__ v_arena,
                  const int* __restrict__ tables, const int* __restrict__ apos,
                  const int* __restrict__ lens, float* __restrict__ out, int G, int R,
                  int D, int Dv, int nb, int bs, int W, int window) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int dp = D + 1;  // padded K row: score loop reads k_s across t
  float* q_s = smem;                   // R x D
  float* k_s = q_s + R * D;            // bs x (D + 1)
  float* v_s = k_s + bs * dp;          // bs x Dv
  float* p_s = v_s + bs * Dv;          // R x bs  scores, then probabilities
  float* acc_s = p_s + R * bs;         // R x Dv
  float* m_s = acc_s + R * Dv;         // R
  float* l_s = m_s + R;                // R
  float* alpha_s = l_s + R;            // R
  int* valid_s = reinterpret_cast<int*>(alpha_s + R);  // bs

  const float* qb = q + ((long long)b * G + g) * R * D;
  for (int i = tid; i < R * D; i += nt) q_s[i] = qb[i];
  for (int i = tid; i < R * Dv; i += nt) acc_s[i] = 0.f;
  if (tid < R) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  const int cl = lens[b] + 1;  // the frontier's own token is visible
  __syncthreads();

  for (int w = 0; w < W; ++w) {
    const int blk = tables[(long long)b * W + w];
    if (blk < 0 || blk >= nb) continue;  // sentinel: same value in every thread
    const long long base = (long long)blk * bs * G;
    for (int i = tid; i < bs * D; i += nt) {
      const int t = i / D, d = i - t * D;
      k_s[t * dp + d] = Dec::get(k_arena[(base + (long long)t * G + g) * D + d]);
    }
    for (int i = tid; i < bs * Dv; i += nt) {
      const int t = i / Dv, d = i - t * Dv;
      v_s[i] = Dec::get(v_arena[(base + (long long)t * G + g) * Dv + d]);
    }
    if (tid < bs) {
      const int a = apos[((long long)b * W + w) * bs + tid];
      bool ok = a >= 0 && a < cl;
      if (window) ok = ok && a >= cl - window;
      valid_s[tid] = ok;
    }
    __syncthreads();

    for (int i = tid; i < R * bs; i += nt) {
      const int r = i / bs, t = i - r * bs;
      const float* qr = q_s + r * D;
      const float* kt = k_s + t * dp;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kt[d], s);
      p_s[i] = valid_s[t] ? s : kNeg;
    }
    __syncthreads();

    if (tid < R) {  // online-softmax step for query head tid
      float* pr = p_s + tid * bs;
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int t = 0; t < bs; ++t) m_new = fmaxf(m_new, pr[t]);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = valid_s[t] ? expf(pr[t] - m_new) : 0.f;
        pr[t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = m_new;
      alpha_s[tid] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < R * Dv; i += nt) {
      const int r = i / Dv, d = i - r * Dv;
      const float* pr = p_s + r * bs;
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) sum = fmaf(pr[t], v_s[t * Dv + d], sum);
      acc_s[i] = acc_s[i] * alpha_s[r] + sum;
    }
    __syncthreads();
  }

  float* ob = out + ((long long)b * G + g) * R * Dv;
  for (int i = tid; i < R * Dv; i += nt) ob[i] = acc_s[i] / fmaxf(l_s[i / Dv], 1e-30f);
}

template <class Dec>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* apos, const void* lens, void* out, int B, int G, int R, int D,
           int Dv, int nb, int bs, int W, int window, cudaStream_t s) {
  const size_t smem = smem_bytes(R, D, Dv, bs);
  paged_attn_kernel<Dec><<<B * G, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const typename Dec::T*>(k),
      static_cast<const typename Dec::T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(apos), static_cast<const int*>(lens),
      static_cast<float*>(out), G, R, D, Dv, nb, bs, W, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one launch needs, so the wrapper can refuse shapes that
// do not fit before launching.
extern "C" long long paged_attn_smem_bytes(int R, int D, int Dv, int bs) {
  return static_cast<long long>(smem_bytes(R, D, Dv, bs));
}

// kv_kind: 0 = f32, 1 = bf16, 2 = posit16 (es 2), 3 = posit8 (es 2).
extern "C" int paged_decode_attention(int kv_kind, const void* q, const void* k_arena,
                                      const void* v_arena, const void* tables,
                                      const void* apos, const void* lens, void* out,
                                      int B, int G, int R, int D, int Dv, int nb, int bs,
                                      int W, int window, void* stream) {
  if (B <= 0 || G <= 0) return 0;
  if (smem_bytes(R, D, Dv, bs) > (size_t)kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_kind) {
    case 0: return launch<DecF32>(q, k_arena, v_arena, tables, apos, lens, out, B, G, R, D, Dv, nb, bs, W, window, s);
    case 1: return launch<DecBF16>(q, k_arena, v_arena, tables, apos, lens, out, B, G, R, D, Dv, nb, bs, W, window, s);
    case 2: return launch<DecPosit16>(q, k_arena, v_arena, tables, apos, lens, out, B, G, R, D, Dv, nb, bs, W, window, s);
    case 3: return launch<DecPosit8>(q, k_arena, v_arena, tables, apos, lens, out, B, G, R, D, Dv, nb, bs, W, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
