// Fused paged-decode attention in MLA latent space: one query token per
// row against the row's block-table latent cache, posit latents decoded
// in-kernel.
//
// Replaces the Pallas TPU kernel ``repro/kernels/posit_paged_attn.py``
// ``paged_decode_attention_mla`` (``_paged_attn_mla_kernel``).  Same
// inputs and result: q_lat (B, H, rank) f32 (the query absorbed through
// wuk), q_rope (B, H, rope) f32; latent arenas c (nb, bs, rank) and
// r (nb, bs, rope) as posit16 / posit8 patterns, f32 or bf16; tables
// (B, W) int32 with the sentinel nb; apos (B, W*bs) int32 (-1 = dead);
// lens (B,) int32 -> latent context (B, H, rank) f32.  The score of a
// slot is (q_lat . c + q_rope . r) * scale; c is also the value, so the
// caller applies wuv to the context.
//
// The TPU kernel walks W as a sequential grid axis with m, l and acc in
// VMEM scratch, one grid row per batch row.  MLA is multi-query: all H
// heads read the same latent block, so one CTA per row would put only B
// CTAs on 132 SMs.  Here one CTA owns (row b, a tile of kHeadTile query
// heads) and walks the row's table in a loop; a sentinel block is
// skipped without a load (all its slots are invalid, so the TPU
// kernel's update is the identity there too).  Each live block's c and
// r patterns are decoded once into one shared bs x (rank + rope) f32
// tile that serves every head of the tile, scored, and folded into the
// running max m, denominator l and latent accumulator acc, all f32.
// Heads past H in the last tile are zero queries whose results are
// never written.  Invalid slots get p = 0 (not exp(-1e30 - m)), so a row
// with no valid slot keeps l == 0 and returns exact zeros.
//
// Bound on the H100 at minicpm3-4b's widths (H 40, rank 256, rope 32):
// operations -- 2 * (rank + rope) + 2 * rank = 1 088 fp32 flops per
// (slot, head) against 2 * (rank + rope) = 576 bytes per slot of posit16
// latents shared by all 40 heads, some 75 flops per byte, above the
// card's fp32 ridge of 67e12 / 3.35e12 = 20.  The kernel reads each live
// block's latents once per head tile (5 tiles at H 40), from L2 after
// the first.  This first version is simple rather than fast: scalar fp32
// FMAs from shared memory, no tensor cores, no TMA, no split over W.
//
// Plain C interface (loaded through ctypes); returns the CUDA error code
// of the launch, 0 on success.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "posit.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kHeadTile = 8;
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

size_t smem_bytes(int rank, int rope, int bs) {
  const size_t kd = (size_t)rank + rope;
  const size_t floats = kHeadTile * kd + (size_t)bs * (kd + 1) + (size_t)kHeadTile * bs +
                        (size_t)kHeadTile * rank + 3 * (size_t)kHeadTile;
  return floats * sizeof(float) + (size_t)bs * sizeof(int);
}

template <class Dec>
__global__ void __launch_bounds__(kThreads)
paged_attn_mla_kernel(const float* __restrict__ q_lat, const float* __restrict__ q_rope,
                      const typename Dec::T* __restrict__ c_arena,
                      const typename Dec::T* __restrict__ r_arena,
                      const int* __restrict__ tables, const int* __restrict__ apos,
                      const int* __restrict__ lens, float* __restrict__ out, int H, int rank,
                      int rope, int nb, int bs, int W, float scale) {
  extern __shared__ float smem[];
  const int n_tiles = (H + kHeadTile - 1) / kHeadTile;
  const int b = blockIdx.x / n_tiles;
  const int h0 = (blockIdx.x % n_tiles) * kHeadTile;
  const int nh = min(kHeadTile, H - h0);  // live heads of this tile
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int kd = rank + rope;
  const int ld = kd + 1;  // padded latent row: the score loop reads kv_s across t
  float* q_s = smem;                          // kHeadTile x kd
  float* kv_s = q_s + kHeadTile * kd;         // bs x ld: c in [0, rank), r in [rank, kd)
  float* p_s = kv_s + bs * ld;                // kHeadTile x bs  scores, then probabilities
  float* acc_s = p_s + kHeadTile * bs;        // kHeadTile x rank
  float* m_s = acc_s + kHeadTile * rank;      // kHeadTile
  float* l_s = m_s + kHeadTile;               // kHeadTile
  float* alpha_s = l_s + kHeadTile;           // kHeadTile
  int* valid_s = reinterpret_cast<int*>(alpha_s + kHeadTile);  // bs

  for (int i = tid; i < kHeadTile * kd; i += nt) {
    const int hh = i / kd, d = i - hh * kd;
    float v = 0.f;
    if (hh < nh) {
      const long long row = (long long)b * H + h0 + hh;
      v = d < rank ? q_lat[row * rank + d] : q_rope[row * rope + (d - rank)];
    }
    q_s[i] = v;
  }
  for (int i = tid; i < kHeadTile * rank; i += nt) acc_s[i] = 0.f;
  if (tid < kHeadTile) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  const int cl = lens[b] + 1;  // the frontier's own token is visible
  __syncthreads();

  for (int w = 0; w < W; ++w) {
    const int blk = tables[(long long)b * W + w];
    if (blk < 0 || blk >= nb) continue;  // sentinel: same value in every thread
    const long long cbase = (long long)blk * bs * rank;
    const long long rbase = (long long)blk * bs * rope;
    for (int i = tid; i < bs * rank; i += nt) {
      const int t = i / rank, d = i - t * rank;
      kv_s[t * ld + d] = Dec::get(c_arena[cbase + i]);
    }
    for (int i = tid; i < bs * rope; i += nt) {
      const int t = i / rope, d = i - t * rope;
      kv_s[t * ld + rank + d] = Dec::get(r_arena[rbase + i]);
    }
    if (tid < bs) {
      const int a = apos[((long long)b * W + w) * bs + tid];
      valid_s[tid] = a >= 0 && a < cl;
    }
    __syncthreads();

    for (int i = tid; i < nh * bs; i += nt) {
      const int hh = i / bs, t = i - hh * bs;
      const float* qh = q_s + hh * kd;
      const float* kt = kv_s + t * ld;
      float sc = 0.f, sr = 0.f;
      for (int d = 0; d < rank; ++d) sc = fmaf(qh[d], kt[d], sc);
      for (int d = rank; d < kd; ++d) sr = fmaf(qh[d], kt[d], sr);
      p_s[i] = valid_s[t] ? (sc + sr) * scale : kNeg;
    }
    __syncthreads();

    if (tid < nh) {  // online-softmax step for head h0 + tid
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

    for (int i = tid; i < nh * rank; i += nt) {
      const int hh = i / rank, d = i - hh * rank;
      const float* pr = p_s + hh * bs;
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) sum = fmaf(pr[t], kv_s[t * ld + d], sum);
      acc_s[i] = acc_s[i] * alpha_s[hh] + sum;
    }
    __syncthreads();
  }

  for (int i = tid; i < nh * rank; i += nt) {
    const int hh = i / rank, d = i - hh * rank;
    out[((long long)b * H + h0 + hh) * rank + d] = acc_s[i] / fmaxf(l_s[hh], 1e-30f);
  }
}

template <class Dec>
int launch(const void* q_lat, const void* q_rope, const void* c, const void* r,
           const void* tables, const void* apos, const void* lens, void* out, int B, int H,
           int rank, int rope, int nb, int bs, int W, float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(rank, rope, bs);
  const int n_tiles = (H + kHeadTile - 1) / kHeadTile;
  paged_attn_mla_kernel<Dec><<<B * n_tiles, kThreads, smem, s>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
      static_cast<const typename Dec::T*>(c), static_cast<const typename Dec::T*>(r),
      static_cast<const int*>(tables), static_cast<const int*>(apos),
      static_cast<const int*>(lens), static_cast<float*>(out), H, rank, rope, nb, bs, W,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one launch needs, so the wrapper can refuse shapes that
// do not fit before launching.
extern "C" long long paged_attn_mla_smem_bytes(int rank, int rope, int bs) {
  return static_cast<long long>(smem_bytes(rank, rope, bs));
}

// kv_kind: 0 = f32, 1 = bf16, 2 = posit16 (es 2), 3 = posit8 (es 2).
extern "C" int paged_decode_attention_mla(int kv_kind, const void* q_lat, const void* q_rope,
                                          const void* c_arena, const void* r_arena,
                                          const void* tables, const void* apos,
                                          const void* lens, void* out, int B, int H, int rank,
                                          int rope, int nb, int bs, int W, float scale,
                                          void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (smem_bytes(rank, rope, bs) > (size_t)kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_kind) {
    case 0: return launch<DecF32>(q_lat, q_rope, c_arena, r_arena, tables, apos, lens, out, B, H, rank, rope, nb, bs, W, scale, s);
    case 1: return launch<DecBF16>(q_lat, q_rope, c_arena, r_arena, tables, apos, lens, out, B, H, rank, rope, nb, bs, W, scale, s);
    case 2: return launch<DecPosit16>(q_lat, q_rope, c_arena, r_arena, tables, apos, lens, out, B, H, rank, rope, nb, bs, W, scale, s);
    case 3: return launch<DecPosit8>(q_lat, q_rope, c_arena, r_arena, tables, apos, lens, out, B, H, rank, rope, nb, bs, W, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
