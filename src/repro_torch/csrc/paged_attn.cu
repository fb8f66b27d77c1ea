// Fused paged-decode attention, split over the block table
// (flash-decoding): one query token per row against the row's
// block-table KV, posit K/V decoded in-kernel.
//
// Replaces the Pallas TPU kernel ``repro/kernels/posit_paged_attn.py``
// ``paged_decode_attention`` (``_paged_attn_kernel``).  Same inputs and
// result: q (B, G, R, D) f32 pre-scaled by D**-0.5; arenas (nb, bs, G, D)
// and (nb, bs, G, Dv) as posit16 / posit8 patterns, f32 or bf16; tables
// (B, W) int32 with the sentinel nb; apos (B, W*bs) int32 (-1 = dead);
// lens (B,) int32 -> out (B, G, R, Dv) f32.
//
// Bound on the H100: memory -- the K/V patterns of each row's live
// blocks, read once (posit16: 2 B x (D + Dv) per slot and KV head).  At
// decode batch sizes that is a few tens of MB, so the kernel has to keep
// the whole card reading: the TPU kernel's sequential walk over W, one
// CTA per (row, KV head), leaves most SMs idle and each CTA waiting on
// one block's loads at a time.  The design:
//
// - Split W.  The grid is (row b, KV head g, head group) x split s; the
//   CTA of split s walks table entries [s*c, s*c + c) (c from the
//   wrapper).  Its live entries are compacted with a warp ballot first,
//   so sentinel entries cost nothing; a split with none loads nothing.
//   Each CTA leaves its online-softmax state (m, l, acc[Dv]) per query
//   head in a scratch tensor; the fold of ``paged_split.cuh`` (a thread
//   per output column, shared with ``paged_attn_mla.cu``) folds the S
//   splits of a head in split order (deterministic) and writes
//   acc / max(l, 1e-30).
//   A split with l == 0 (no valid slot) has acc == 0 and is given weight
//   0, whatever its m, so an all-masked row comes out as exact zeros.
//   With one split the CTA writes the output itself and no fold runs.
// - Overlap.  Block i+1's K and V patterns are in flight (``cp.async``,
//   16-byte copies, into the other of two shared-memory stages), and its
//   slots' apos in a register, while block i is decoded and scored.
// - Decode once, in registers.  All 128 threads turn the stage's
//   16-byte pattern vectors into f32 in shared memory (posit8/16 with
//   ``to_f32_narrow``, exact without rounding), once per block for all
//   query heads of the KV head.  K rows are padded to an odd number of
//   16-byte words, so the score's LDS.128 of 8 lanes hit 32 banks.
// - Warps, not threads, for the math.  Warp w owns query heads
//   (HPW of them, m and l in registers, q in shared memory); lane t
//   scores slot t, one FMA chain over d = 0, 1, ..., D-1 per head --
//   the order of an f32 matmul's inner loop (the plain version's
//   einsum), so the scores and their exp agree with it to the last
//   bits, which a shuffle tree over D does not at un-scaled q.  The
//   block's max, exp and sum run across lanes, and for P.V the lanes
//   span Dv with acc[Dv] in registers.
// - Edges.  Rows whose bytes are not a multiple of 16 (ragged D or Dv)
//   or arenas not 16-byte aligned take a scalar copy into the same
//   stages; blocks larger than 32 slots are scored 32 at a time.  D and
//   Dv are at most 256 (8 values per lane).
//
// Masking contract (``models/layers.py::paged_apos``): a slot counts iff
// 0 <= apos < lens + 1, it is inside the window when one is set, and its
// table entry is not the sentinel.  Invalid slots get p = 0.
//
// Plain C interface (loaded through ctypes); returns the CUDA error code
// of the launches, 0 on success.
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_split.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunk = 32;        // table entries per split: one ballot
constexpr int kMaxSmem = 232448;     // H100: 227 KB of shared memory a block

using paged_split::DecBF16;
using paged_split::DecF32;
using paged_split::DecPosit16;
using paged_split::DecPosit8;
using paged_split::cp_async16;
using paged_split::cp_async_commit;
using paged_split::cp_async_wait1;
using paged_split::warp_max;
using paged_split::warp_sum;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// Row strides in floats of the decoded K block (an odd number of
// 16-byte words) and of the CTA's query heads in shared memory.
__host__ __device__ inline int k_stride(int D) { return (((D + 3) / 4) | 1) * 4; }
__host__ __device__ inline int q_stride(int D) { return (D + 3) / 4 * 4; }

// Shared memory of one split CTA: two stages of raw K and V patterns,
// the decoded f32 block, the query heads, the slots' valid flags, the
// live entries.
size_t smem_bytes(int es, int D, int Dv, int bs, int hpw) {
  const size_t stage = align16((size_t)bs * D * es) + align16((size_t)bs * Dv * es);
  return 2 * stage +
         ((size_t)bs * (k_stride(D) + Dv) + (size_t)kWarps * hpw * q_stride(D)) * sizeof(float) +
         align16((size_t)bs * sizeof(int)) + (2 * kMaxChunk + 4) * sizeof(int);
}

// One CTA: (row b, KV head g, head group hg) x split.  Query heads
// hg*4*HPW + warp*HPW + h for h < HPW; Dv <= 32*DPL.
template <class Dec, int HPW, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_attn_split(const float* __restrict__ q, const typename Dec::T* __restrict__ k_arena,
                 const typename Dec::T* __restrict__ v_arena, const int* __restrict__ tables,
                 const int* __restrict__ apos, const int* __restrict__ lens,
                 float* __restrict__ out, float* __restrict__ part_acc,
                 float* __restrict__ part_ml, int G, int R, int D, int Dv, int nb, int bs,
                 int W, int window, int chunk, int n_hg, int vec) {
  using T = typename Dec::T;
  constexpr int kVec = Dec::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hg = blockIdx.x % n_hg;
  const int bg = blockIdx.x / n_hg;
  const int b = bg / G, g = bg % G;
  const int split = blockIdx.y, n_split = gridDim.y;

  const size_t rk_bytes = align16((size_t)bs * D * sizeof(T));
  const size_t stage_bytes = rk_bytes + align16((size_t)bs * Dv * sizeof(T));
  const int ldk = k_stride(D), ldq = q_stride(D);
  float* kf = reinterpret_cast<float*>(smem + 2 * stage_bytes);   // bs x ldk
  float* qs = kf + bs * ldk;                                       // 4*HPW x ldq
  float* vf = qs + kWarps * HPW * ldq;                             // bs x Dv
  int* valid_s = reinterpret_cast<int*>(vf + bs * Dv);             // bs
  int* live_e = valid_s + ((bs + 3) & ~3);                         // chunk
  int* live_blk = live_e + kMaxChunk;                              // chunk
  int* n_live_s = live_blk + kMaxChunk;

  const int w0 = split * chunk;
  if (warp == 0) {  // compact this split's live table entries, in order
    const int e = w0 + lane;
    const int blk = (lane < chunk && e < W) ? tables[(long long)b * W + e] : nb;
    const bool live = lane < chunk && e < W && blk >= 0 && blk < nb;
    const unsigned mask = __ballot_sync(0xFFFFFFFFu, live);
    if (live) {
      const int at = __popc(mask & ((1u << lane) - 1u));
      live_e[at] = e;
      live_blk[at] = blk;
    }
    if (lane == 0) *n_live_s = __popc(mask);
  }

  // the CTA's query heads into shared memory (0 past R)
  for (int i = tid; i < kWarps * HPW * D; i += kThreads) {
    const int hh = i / D, d = i - hh * D;
    const int r = hg * kWarps * HPW + hh;
    qs[hh * ldq + d] = r < R ? q[(((long long)b * G + g) * R + r) * D + d] : 0.f;
  }
  // this warp's heads' state; its lanes' slices of Dv
  float acc[HPW][DPL], m[HPW], l[HPW];
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[h][i] = 0.f;
    m[h] = kNeg;
    l[h] = 0.f;
  }
  const int cl = lens[b] + 1;  // the frontier's own token is visible
  __syncthreads();
  const int n_live = *n_live_s;

  // block `blk`'s K and V rows of head g into raw stage `st`
  // slot tid's apos of the block in flight (bs <= 128; larger blocks
  // read theirs when decoding)
  int apos_next = -1;
  auto prefetch = [&](int blk, int e, int st) {
    if (bs <= kThreads && tid < bs) apos_next = apos[((long long)b * W + e) * bs + tid];
    unsigned char* rk = smem + st * stage_bytes;
    unsigned char* rv = rk + rk_bytes;
    const long long row0 = (long long)blk * bs * G + g;  // slot t: row0 + t*G
    if (vec) {
      const int ck = D * (int)sizeof(T) / 16, cv = Dv * (int)sizeof(T) / 16;
      for (int i = tid; i < bs * ck; i += kThreads) {
        const int t = i / ck, j = i - t * ck;
        cp_async16(rk + 16 * i, reinterpret_cast<const unsigned char*>(
                                    k_arena + (row0 + (long long)t * G) * D) + 16 * j);
      }
      for (int i = tid; i < bs * cv; i += kThreads) {
        const int t = i / cv, j = i - t * cv;
        cp_async16(rv + 16 * i, reinterpret_cast<const unsigned char*>(
                                    v_arena + (row0 + (long long)t * G) * Dv) + 16 * j);
      }
    } else {  // scalar edge path: plain loads into the same layout
      T* k_s = reinterpret_cast<T*>(rk);
      T* v_s = reinterpret_cast<T*>(rv);
      for (int i = tid; i < bs * D; i += kThreads) {
        const int t = i / D, d = i - t * D;
        k_s[i] = k_arena[(row0 + (long long)t * G) * D + d];
      }
      for (int i = tid; i < bs * Dv; i += kThreads) {
        const int t = i / Dv, d = i - t * Dv;
        v_s[i] = v_arena[(row0 + (long long)t * G) * Dv + d];
      }
    }
  };

  if (n_live > 0) prefetch(live_blk[0], live_e[0], 0);
  cp_async_commit();
  for (int it = 0; it < n_live; ++it) {
    const int apos_cur = apos_next;
    if (it + 1 < n_live) prefetch(live_blk[it + 1], live_e[it + 1], (it + 1) & 1);
    cp_async_commit();
    cp_async_wait1();  // block it's copies have landed (this thread's)
    __syncthreads();   // ... everyone's; and block it-1's math is done

    // decode block it into f32, and its slots' valid flags
    const unsigned char* rk = smem + (it & 1) * stage_bytes;
    const unsigned char* rv = rk + rk_bytes;
    if (vec) {
      const int nk = bs * D / kVec, nv = bs * Dv / kVec;
      for (int i = tid; i < nk + nv; i += kThreads) {
        const bool is_k = i < nk;
        const int j = is_k ? i : i - nk;
        const uint4 u = reinterpret_cast<const uint4*>(is_k ? rk : rv)[j];
        float f[kVec];
        Dec::vec(u, f);
        // a vector never straddles two rows: kVec divides D and Dv here
        const int t = j * kVec / D;
        float4* dst = reinterpret_cast<float4*>(
            is_k ? kf + t * ldk + (j * kVec - t * D) : vf + j * kVec);
#pragma unroll
        for (int x = 0; x < kVec / 4; ++x)
          dst[x] = make_float4(f[4 * x], f[4 * x + 1], f[4 * x + 2], f[4 * x + 3]);
      }
    } else {
      const T* k_s = reinterpret_cast<const T*>(rk);
      const T* v_s = reinterpret_cast<const T*>(rv);
      for (int i = tid; i < bs * D; i += kThreads) {
        const int t = i / D;
        kf[t * ldk + (i - t * D)] = Dec::get(k_s[i]);
      }
      for (int i = tid; i < bs * Dv; i += kThreads) vf[i] = Dec::get(v_s[i]);
    }
    const int e = live_e[it];
    for (int t = tid; t < bs; t += kThreads) {
      const int a = bs <= kThreads ? apos_cur : apos[((long long)b * W + e) * bs + t];
      bool ok = a >= 0 && a < cl;
      if (window) ok = ok && a >= cl - window;
      valid_s[t] = ok;
    }
    __syncthreads();

    // the warp's heads over the block, 32 slots at a time
    for (int t0 = 0; t0 < bs; t0 += 32) {
      const int nt = bs - t0 < 32 ? bs - t0 : 32;
      // lane t: slot t0 + t's scores, one FMA chain over d per head
      // (lanes past nt read slot t0, a broadcast, and are masked)
      const int tl = t0 + (lane < nt ? lane : 0);
      const float* kt = kf + tl * ldk;
      const float* qw = qs + warp * HPW * ldq;
      float s_mine[HPW];
#pragma unroll
      for (int h = 0; h < HPW; ++h) s_mine[h] = 0.f;
      int d = 0;
#pragma unroll 4
      for (; d + 4 <= D; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kt + d);
#pragma unroll
        for (int h = 0; h < HPW; ++h) {
          const float4 qv = *reinterpret_cast<const float4*>(qw + h * ldq + d);
          s_mine[h] = fmaf(qv.x, kv.x, s_mine[h]);
          s_mine[h] = fmaf(qv.y, kv.y, s_mine[h]);
          s_mine[h] = fmaf(qv.z, kv.z, s_mine[h]);
          s_mine[h] = fmaf(qv.w, kv.w, s_mine[h]);
        }
      }
      for (; d < D; ++d) {
        const float kv = kt[d];
#pragma unroll
        for (int h = 0; h < HPW; ++h) s_mine[h] = fmaf(qw[h * ldq + d], kv, s_mine[h]);
      }
      const bool ok = lane < nt && valid_s[tl];
      float p[HPW];
#pragma unroll
      for (int h = 0; h < HPW; ++h) {
        const float s = ok ? s_mine[h] : kNeg;
        const float m_new = fmaxf(m[h], warp_max(s));
        p[h] = ok ? expf(s - m_new) : 0.f;
        const float alpha = expf(m[h] - m_new);
        l[h] = l[h] * alpha + warp_sum(p[h]);
        m[h] = m_new;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[h][i] *= alpha;
      }
#pragma unroll 4
      for (int t = 0; t < nt; ++t) {
        const float* vt = vf + (t0 + t) * Dv;
        float pt[HPW];
#pragma unroll
        for (int h = 0; h < HPW; ++h) pt[h] = __shfl_sync(0xFFFFFFFFu, p[h], t);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < Dv) {
            const float vv = vt[d];
#pragma unroll
            for (int h = 0; h < HPW; ++h) acc[h][i] = fmaf(pt[h], vv, acc[h][i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    const int r = hg * kWarps * HPW + warp * HPW + h;
    if (r >= R) continue;
    const long long row = ((long long)b * G + g) * R + r;
    if (n_split == 1) {
      const float lc = fmaxf(l[h], 1e-30f);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < Dv) out[row * Dv + d] = acc[h][i] / lc;
      }
    } else {
      float* pa = part_acc + (row * n_split + split) * Dv;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < Dv) pa[d] = acc[h][i];
      }
      if (lane == 0) {
        part_ml[(row * n_split + split) * 2] = m[h];
        part_ml[(row * n_split + split) * 2 + 1] = l[h];
      }
    }
  }
}

template <class Dec, int HPW, int DPL>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* apos, const void* lens, void* out, void* scratch, int B, int G,
           int R, int D, int Dv, int nb, int bs, int W, int window, int chunk,
           cudaStream_t s) {
  using T = typename Dec::T;
  const size_t smem = smem_bytes(sizeof(T), D, Dv, bs, HPW);
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = paged_attn_split<Dec, HPW, DPL>;
  static size_t granted[64] = {};  // this kernel's opt-in, per device
  const cudaError_t e = paged_split::allow_smem(kernel, smem, granted);  // past 48 KB
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_hg = (R + kWarps * HPW - 1) / (kWarps * HPW);
  const int n_split = (W + chunk - 1) / chunk;
  const bool vec = (D * sizeof(T)) % 16 == 0 && (Dv * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const long long rows = (long long)B * G * R;
  float* part_acc = static_cast<float*>(scratch);
  float* part_ml = part_acc + rows * n_split * Dv;
  const dim3 grid(static_cast<unsigned>((long long)B * G * n_hg), static_cast<unsigned>(n_split));
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(tables), static_cast<const int*>(apos),
      static_cast<const int*>(lens), static_cast<float*>(out), part_acc, part_ml, G, R, D,
      Dv, nb, bs, W, window, chunk, n_hg, vec ? 1 : 0);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || n_split == 1) return rc;
  return paged_split::fold(part_acc, part_ml, static_cast<float*>(out), rows, n_split, Dv, s);
}

template <class Dec>
int dispatch(const void* q, const void* k, const void* v, const void* tables,
             const void* apos, const void* lens, void* out, void* scratch, int B, int G,
             int R, int D, int Dv, int nb, int bs, int W, int window, int chunk,
             cudaStream_t s) {
  const bool one = R <= kWarps;  // one head per warp, else two
#define PA_LAUNCH(HPW, DPL) \
  launch<Dec, HPW, DPL>(q, k, v, tables, apos, lens, out, scratch, B, G, R, D, Dv, nb, bs, W, window, chunk, s)
  if (Dv <= 128) return one ? PA_LAUNCH(1, 4) : PA_LAUNCH(2, 4);
  return one ? PA_LAUNCH(1, 8) : PA_LAUNCH(2, 8);
#undef PA_LAUNCH
}

}  // namespace

// kv_kind: 0 = f32, 1 = bf16, 2 = posit16 (es 2), 3 = posit8 (es 2).
// chunk: table entries per split (1..32); with W > chunk the CTAs leave
// partials in scratch (B*G*R*S*(Dv + 2) floats, S = ceil(W / chunk))
// and a fold writes out.
extern "C" int paged_decode_attention(int kv_kind, const void* q, const void* k_arena,
                                      const void* v_arena, const void* tables,
                                      const void* apos, const void* lens, void* out,
                                      void* scratch, int B, int G, int R, int D, int Dv,
                                      int nb, int bs, int W, int window, int chunk,
                                      void* stream) {
  if (B <= 0 || G <= 0 || R <= 0) return 0;
  if (D <= 0 || Dv <= 0 || D > 256 || Dv > 256 || bs <= 0 || W <= 0 || chunk <= 0 ||
      chunk > kMaxChunk || (long long)B * G * R > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_kind) {
    case 0: return dispatch<DecF32>(q, k_arena, v_arena, tables, apos, lens, out, scratch, B, G, R, D, Dv, nb, bs, W, window, chunk, s);
    case 1: return dispatch<DecBF16>(q, k_arena, v_arena, tables, apos, lens, out, scratch, B, G, R, D, Dv, nb, bs, W, window, chunk, s);
    case 2: return dispatch<DecPosit16>(q, k_arena, v_arena, tables, apos, lens, out, scratch, B, G, R, D, Dv, nb, bs, W, window, chunk, s);
    case 3: return dispatch<DecPosit8>(q, k_arena, v_arena, tables, apos, lens, out, scratch, B, G, R, D, Dv, nb, bs, W, window, chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

