// Fused paged-decode attention in MLA latent space, split over the block
// table (flash-decoding): one query token per row against the row's
// block-table latent cache, posit latents decoded in-kernel.
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
// Bound on the H100 at minicpm3-4b's widths (H 40, rank 256, rope 32):
// fp32 operations -- 2 * (rank + rope) + 2 * rank = 1 088 flops per
// (slot, head) against 576 bytes per slot of posit16 latents shared by
// all 40 heads, some 75 flops per byte, above the card's fp32 ridge of
// 67e12 / 3.35e12 = 20.  At decode batch sizes that is a few microseconds
// of work, so what bounds a simple kernel is parallelism and latency:
// the TPU kernel's sequential walk over W, as one CTA per (row, head
// tile) walking the whole table, put 40 CTAs on 132 SMs, each waiting on
// one block's loads at a time, and decoded every block once per tile.
// The design:
//
// - Split W, all heads in the CTA.  The grid is row b x split s; the CTA
//   of split s walks table entries [s*c, s*c + c) (c from the wrapper)
//   for all H query heads, so each live latent block is loaded and
//   decoded once per row.  Live entries are compacted with a warp ballot
//   first: sentinel entries cost nothing and a split with none loads
//   nothing.  Each CTA leaves its online-softmax state (m, l, acc[rank])
//   per head in a scratch tensor, and the fold of ``paged_split.cuh``
//   (shared with ``paged_attn.cu``) combines the S splits in split order;
//   a split with l == 0 weighs 0, so an all-masked row is exact zeros.
//   With one split the CTA writes the output itself.
// - Overlap.  Block i+1's c and r patterns are in flight (``cp.async``,
//   16-byte copies, into the other of two shared-memory stages), and its
//   slots' apos in a register, while block i is decoded and scored.
//   The row's query heads travel the same way, with the first block.
// - Every thread busy.  The block is decoded once into a shared f32 tile
//   (16-byte pattern vectors, ``to_f32_narrow``, exact).  Scores: a
//   thread per (slot, pair of heads), 640 scores per block at minicpm3
//   on 320 threads, each one FMA chain over the latent part and one over
//   the RoPE part, summed and then scaled -- the order of the plain
//   version.  Latent rows are padded to an odd number of 16-byte words so
//   the LDS.128 of 8 slots hit 32 banks.  The online-softmax step runs
//   a group of lanes per head (two heads a warp at bs 16; max, exp and
//   sum across the group).  P.V: a thread per (4 latent columns, 8
//   heads), 32 accumulators in registers, rescaled by alpha and then
//   accumulating the block's p * c.
// - Edges.  Latent widths whose rows are not a multiple of 16 bytes, or
//   arenas or queries not 16-byte aligned, take scalar copies into the
//   same places.  The CTA has 32 * ceil(ceil(rank / 4) * ceil(H / 8) / 32)
//   threads, at least 128 and at most 512; shared memory grows with
//   H x (rank + rope) (86.8 KB at minicpm3, posit16) up to the card's
//   227 KB.
//   At 128 registers a thread one CTA is resident per SM, so the
//   wrapper's split policy aims the grid at one wave.
//
// Masking contract (``models/layers.py::paged_apos``): a slot counts iff
// 0 <= apos < lens + 1 and its table entry is not the sentinel.  Invalid
// slots get p = 0 (not exp(-1e30 - m)).
//
// Plain C interface (loaded through ctypes); returns the CUDA error code
// of the launches, 0 on success.
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_split.cuh"

namespace {

using paged_split::DecBF16;
using paged_split::DecF32;
using paged_split::DecPosit16;
using paged_split::DecPosit8;
using paged_split::cp_async16;
using paged_split::cp_async_commit;
using paged_split::cp_async_wait1;

constexpr float kNeg = -1e30f;
constexpr int kHPG = 8;              // query heads of one P.V thread
constexpr int kTH = 2;               // query heads of one score thread
constexpr int kMinThreads = 128;
constexpr int kMaxThreads = 512;     // 128 registers a thread
constexpr int kMaxChunk = 32;        // table entries per split: one ballot
constexpr int kMaxSmem = 232448;     // H100: 227 KB of shared memory a block

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// Row strides in floats: the decoded latent block (an odd number of
// 16-byte words), the query heads, the block's probabilities (a slot's
// heads, padded so the warp-per-head softmax spreads over banks).
__host__ __device__ inline int kv_stride(int kd) { return (((kd + 3) / 4) | 1) * 4; }
__host__ __device__ inline int q_stride(int kd) { return (kd + 3) / 4 * 4; }
__host__ __device__ inline int heads_padded(int H) { return (H + kHPG - 1) / kHPG * kHPG; }
__host__ __device__ inline int p_stride(int H) { return heads_padded(H) + 4; }

int threads_for(int H, int rank) {
  const int n = ((rank + 3) / 4) * ((H + kHPG - 1) / kHPG);
  const int t = (n + 31) / 32 * 32;
  return t < kMinThreads ? kMinThreads : t;
}

// Shared memory of one split CTA: two stages of raw c and r patterns,
// the decoded f32 block, the query heads, the block's scores, m, l and
// alpha per head, the slots' valid flags, the live entries.
size_t smem_bytes(int es, int H, int rank, int rope, int bs) {
  const int kd = rank + rope;
  const int hp = heads_padded(H);
  const size_t stage = align16((size_t)bs * rank * es) + align16((size_t)bs * rope * es);
  const size_t floats = (size_t)bs * kv_stride(kd) + (size_t)hp * q_stride(kd) +
                        (size_t)bs * p_stride(H) + 3 * (size_t)hp;
  return 2 * stage + floats * sizeof(float) + align16((size_t)bs * sizeof(int)) +
         (2 * kMaxChunk + 4) * sizeof(int);
}

int kv_size(int kv_kind) {
  switch (kv_kind) {
    case 0: return 4;
    case 1: return 2;
    case 2: return 2;
    case 3: return 1;
    default: return 0;
  }
}

// One CTA: row b x split.  All H heads (padded to hp with zero queries
// whose results are never written).
template <class Dec>
__global__ void __launch_bounds__(kMaxThreads)
paged_attn_mla_split(const float* __restrict__ q_lat, const float* __restrict__ q_rope,
                     const typename Dec::T* __restrict__ c_arena,
                     const typename Dec::T* __restrict__ r_arena,
                     const int* __restrict__ tables, const int* __restrict__ apos,
                     const int* __restrict__ lens, float* __restrict__ out,
                     float* __restrict__ part_acc, float* __restrict__ part_ml, int H, int rank,
                     int rope, int nb, int bs, int W, int chunk, float scale, int vec,
                     int vec_q) {
  using T = typename Dec::T;
  constexpr int kVec = Dec::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5, n_warps = nt >> 5;
  const int b = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int kd = rank + rope, ld = kv_stride(kd), ldq = q_stride(kd);
  const int hp = heads_padded(H), ph = p_stride(H);

  const size_t rc_bytes = align16((size_t)bs * rank * sizeof(T));
  const size_t stage_bytes = rc_bytes + align16((size_t)bs * rope * sizeof(T));
  float* kf = reinterpret_cast<float*>(smem + 2 * stage_bytes);  // bs x ld: c, then r
  float* q_s = kf + bs * ld;                                      // hp x ldq
  float* p_s = q_s + hp * ldq;                                    // bs x ph
  float* m_s = p_s + bs * ph;                                     // hp
  float* l_s = m_s + hp;                                          // hp
  float* alpha_s = l_s + hp;                                      // hp
  int* valid_s = reinterpret_cast<int*>(alpha_s + hp);            // bs
  int* live_e = valid_s + ((bs + 3) & ~3);                        // chunk
  int* live_blk = live_e + kMaxChunk;                             // chunk
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
  for (int h = tid; h < hp; h += nt) {
    m_s[h] = kNeg;
    l_s[h] = 0.f;
  }
  const int cl = lens[b] + 1;  // the frontier's own token is visible
  __syncthreads();
  const int n_live = *n_live_s;

  // this thread's P.V share: latent columns 4*cq .. 4*cq+3 of heads
  // hg*8 .. hg*8+7 (threads past the last group idle there)
  const int n_quads = (rank + 3) / 4;
  const int cq = tid % n_quads, hg = tid / n_quads;
  const bool pv = hg * kHPG < hp;
  float acc[kHPG][4];
#pragma unroll
  for (int j = 0; j < kHPG; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;

  // block `blk`'s c and r patterns into raw stage `st`; slot tid's apos
  // of the block in flight (bs <= threads; larger blocks read theirs
  // when decoding)
  int apos_next = -1;
  auto prefetch = [&](int blk, int e, int st) {
    if (bs <= nt && tid < bs) apos_next = apos[((long long)b * W + e) * bs + tid];
    unsigned char* rc = smem + st * stage_bytes;
    unsigned char* rr = rc + rc_bytes;
    const T* gc = c_arena + (long long)blk * bs * rank;
    const T* gr = r_arena + (long long)blk * bs * rope;
    if (vec) {  // a block's c (and r) patterns are one contiguous run
      const int nc = bs * rank * (int)sizeof(T) / 16, nr = bs * rope * (int)sizeof(T) / 16;
      for (int i = tid; i < nc; i += nt)
        cp_async16(rc + 16 * i, reinterpret_cast<const unsigned char*>(gc) + 16 * i);
      for (int i = tid; i < nr; i += nt)
        cp_async16(rr + 16 * i, reinterpret_cast<const unsigned char*>(gr) + 16 * i);
    } else {  // scalar edge path: plain loads into the same layout
      T* c_s = reinterpret_cast<T*>(rc);
      T* r_s = reinterpret_cast<T*>(rr);
      for (int i = tid; i < bs * rank; i += nt) c_s[i] = gc[i];
      for (int i = tid; i < bs * rope; i += nt) r_s[i] = gr[i];
    }
  };

  if (n_live > 0) {
    prefetch(live_blk[0], live_e[0], 0);
    // the row's query heads (zeros past H), in flight with block 0
    const float* ql = q_lat + (long long)b * H * rank;
    const float* qr = q_rope + (long long)b * H * rope;
    if (vec_q) {
      const int vl = rank / 4, vr = rope / 4, per = vl + vr;
      for (int i = tid; i < H * per; i += nt) {
        const int h = i / per, j = i - h * per;
        const float* src = j < vl ? ql + h * rank + 4 * j : qr + h * rope + 4 * (j - vl);
        cp_async16(q_s + h * ldq + 4 * j, src);
      }
    } else {
      for (int i = tid; i < H * kd; i += nt) {
        const int h = i / kd, d = i - h * kd;
        q_s[h * ldq + d] = d < rank ? ql[h * rank + d] : qr[h * rope + (d - rank)];
      }
    }
    for (int i = tid; i < (hp - H) * kd; i += nt) {
      const int h = H + i / kd;
      q_s[h * ldq + (i - (h - H) * kd)] = 0.f;
    }
  }
  cp_async_commit();

  for (int it = 0; it < n_live; ++it) {
    const int apos_cur = apos_next;
    if (it + 1 < n_live) prefetch(live_blk[it + 1], live_e[it + 1], (it + 1) & 1);
    cp_async_commit();
    cp_async_wait1();  // block it's copies have landed (this thread's)
    __syncthreads();   // ... everyone's; and block it-1's P.V is done

    // decode block it into f32, and its slots' valid flags
    const unsigned char* rc = smem + (it & 1) * stage_bytes;
    const unsigned char* rr = rc + rc_bytes;
    if (vec) {
      const int nc = bs * rank / kVec, nr = bs * rope / kVec;
      for (int i = tid; i < nc + nr; i += nt) {
        const bool is_c = i < nc;
        const int j = is_c ? i : i - nc;
        const uint4 u = reinterpret_cast<const uint4*>(is_c ? rc : rr)[j];
        float f[kVec];
        Dec::vec(u, f);
        // a vector never straddles two slots: kVec divides rank and rope
        const int width = is_c ? rank : rope;
        const int t = j * kVec / width;
        float4* dst = reinterpret_cast<float4*>(kf + t * ld + (is_c ? 0 : rank) +
                                                (j * kVec - t * width));
#pragma unroll
        for (int x = 0; x < kVec / 4; ++x)
          dst[x] = make_float4(f[4 * x], f[4 * x + 1], f[4 * x + 2], f[4 * x + 3]);
      }
    } else {
      const T* c_s = reinterpret_cast<const T*>(rc);
      const T* r_s = reinterpret_cast<const T*>(rr);
      for (int i = tid; i < bs * rank; i += nt) {
        const int t = i / rank;
        kf[t * ld + (i - t * rank)] = Dec::get(c_s[i]);
      }
      for (int i = tid; i < bs * rope; i += nt) {
        const int t = i / rope;
        kf[t * ld + rank + (i - t * rope)] = Dec::get(r_s[i]);
      }
    }
    const int e = live_e[it];
    for (int t = tid; t < bs; t += nt) {
      const int a = bs <= nt ? apos_cur : apos[((long long)b * W + e) * bs + t];
      valid_s[t] = a >= 0 && a < cl;
    }
    __syncthreads();

    // scores: a thread per (slot t, heads kTH*hq ..): per head one FMA
    // chain over the latent part, one over the RoPE part.  Neighbouring
    // lanes take neighbouring slots (rows 16 bytes apart in banks) and
    // share their heads (a broadcast).
    for (int i = tid; i < bs * (hp / kTH); i += nt) {
      const int hq = i / bs, t = i - hq * bs;
      const float* kt = kf + t * ld;
      const float* qh = q_s + kTH * hq * ldq;
      float c[kTH], r[kTH];
#pragma unroll
      for (int j = 0; j < kTH; ++j) c[j] = r[j] = 0.f;
      int d = 0;
#pragma unroll 4
      for (; d + 4 <= rank; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kt + d);
#pragma unroll
        for (int j = 0; j < kTH; ++j) {
          const float4 q = *reinterpret_cast<const float4*>(qh + j * ldq + d);
          c[j] = fmaf(q.x, kv.x, c[j]); c[j] = fmaf(q.y, kv.y, c[j]);
          c[j] = fmaf(q.z, kv.z, c[j]); c[j] = fmaf(q.w, kv.w, c[j]);
        }
      }
      for (; d < rank; ++d)
#pragma unroll
        for (int j = 0; j < kTH; ++j) c[j] = fmaf(qh[j * ldq + d], kt[d], c[j]);
      if ((rank & 3) == 0) {
        for (; d + 4 <= kd; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kt + d);
#pragma unroll
          for (int j = 0; j < kTH; ++j) {
            const float4 q = *reinterpret_cast<const float4*>(qh + j * ldq + d);
            r[j] = fmaf(q.x, kv.x, r[j]); r[j] = fmaf(q.y, kv.y, r[j]);
            r[j] = fmaf(q.z, kv.z, r[j]); r[j] = fmaf(q.w, kv.w, r[j]);
          }
        }
      }
      for (; d < kd; ++d)
#pragma unroll
        for (int j = 0; j < kTH; ++j) r[j] = fmaf(qh[j * ldq + d], kt[d], r[j]);
      const bool ok = valid_s[t];
#pragma unroll
      for (int j = 0; j < kTH; ++j)
        p_s[t * ph + kTH * hq + j] = ok ? (c[j] + r[j]) * scale : kNeg;
    }
    __syncthreads();

    // online-softmax step: a group of gs lanes per head (32 / gs heads
    // per warp at once), lanes over slots, reductions within the group
    {
      const int gs = bs >= 32 ? 32 : bs > 16 ? 32 : bs > 8 ? 16 : bs > 4 ? 8 : bs > 2 ? 4 : bs;
      const int hpw = 32 / gs;
      const int sub = lane / gs, tl = lane - sub * gs;
      for (int h0 = warp * hpw; h0 < hp; h0 += n_warps * hpw) {
        const int h = h0 + sub;
        const bool live = h < hp;
        float mx = kNeg;
        if (live)
          for (int t = tl; t < bs; t += gs) mx = fmaxf(mx, p_s[t * ph + h]);
        for (int o = gs / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
        const float m_prev = live ? m_s[h] : kNeg;
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        if (live)
          for (int t = tl; t < bs; t += gs) {
            const float p = valid_s[t] ? expf(p_s[t * ph + h] - m_new) : 0.f;
            p_s[t * ph + h] = p;
            sum += p;
          }
        for (int o = gs / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xFFFFFFFFu, sum, o);
        if (live && tl == 0) {
          const float alpha = expf(m_prev - m_new);
          l_s[h] = l_s[h] * alpha + sum;
          m_s[h] = m_new;
          alpha_s[h] = alpha;
        }
      }
    }
    __syncthreads();

    // P.V: acc * alpha, then the block's p * c summed into it
    if (pv) {
      const float4 a0 = *reinterpret_cast<const float4*>(alpha_s + hg * kHPG);
      const float4 a1 = *reinterpret_cast<const float4*>(alpha_s + hg * kHPG + 4);
      const float al[kHPG] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int j = 0; j < kHPG; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][k] *= al[j];
      const float* pcol = p_s + hg * kHPG;
      const float* ccol = kf + 4 * cq;
#pragma unroll 2
      for (int t = 0; t < bs; ++t) {
        const float4 cv = *reinterpret_cast<const float4*>(ccol + t * ld);
        const float4 p0 = *reinterpret_cast<const float4*>(pcol + t * ph);
        const float4 p1 = *reinterpret_cast<const float4*>(pcol + t * ph + 4);
        const float pp[kHPG] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int j = 0; j < kHPG; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[j][k] = fmaf(pp[j], cc[k], acc[j][k]);
      }
    }
  }

  if (pv) {
#pragma unroll
    for (int j = 0; j < kHPG; ++j) {
      const int h = hg * kHPG + j;
      if (h >= H) continue;
      const long long row = (long long)b * H + h;
      float* dst = n_split == 1 ? out + row * rank : part_acc + (row * n_split + split) * rank;
      const float lc = n_split == 1 ? fmaxf(l_s[h], 1e-30f) : 1.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d = 4 * cq + k;
        if (d < rank) dst[d] = n_split == 1 ? acc[j][k] / lc : acc[j][k];
      }
    }
  }
  if (n_split > 1) {
    for (int h = tid; h < H; h += nt) {
      const long long at = ((long long)b * H + h) * n_split + split;
      part_ml[2 * at] = m_s[h];
      part_ml[2 * at + 1] = l_s[h];
    }
  }
}

template <class Dec>
int launch(const void* q_lat, const void* q_rope, const void* c, const void* r,
           const void* tables, const void* apos, const void* lens, void* out, void* scratch,
           int B, int H, int rank, int rope, int nb, int bs, int W, int chunk, float scale,
           cudaStream_t s) {
  using T = typename Dec::T;
  const size_t smem = smem_bytes(sizeof(T), H, rank, rope, bs);
  const int nt = threads_for(H, rank);
  if (smem > (size_t)kMaxSmem || nt > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = paged_attn_mla_split<Dec>;
  static size_t granted[64] = {};  // this kernel's opt-in, per device
  const cudaError_t e = paged_split::allow_smem(kernel, smem, granted);  // past 48 KB
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_split = (W + chunk - 1) / chunk;
  const bool vec = (rank * sizeof(T)) % 16 == 0 && (rope * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(r) % 16 == 0;
  const bool vec_q = rank % 4 == 0 && rope % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(q_lat) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(q_rope) % 16 == 0;
  const long long rows = (long long)B * H;
  float* part_acc = static_cast<float*>(scratch);
  float* part_ml = part_acc + rows * n_split * rank;
  const dim3 grid(static_cast<unsigned>(B), static_cast<unsigned>(n_split));
  kernel<<<grid, nt, smem, s>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
      static_cast<const T*>(c), static_cast<const T*>(r), static_cast<const int*>(tables),
      static_cast<const int*>(apos), static_cast<const int*>(lens), static_cast<float*>(out),
      part_acc, part_ml, H, rank, rope, nb, bs, W, chunk, scale, vec ? 1 : 0, vec_q ? 1 : 0);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || n_split == 1) return rc;
  return paged_split::fold(part_acc, part_ml, static_cast<float*>(out), rows, n_split, rank, s);
}

}  // namespace

// Shared memory and threads of one split CTA, so the wrapper can refuse
// shapes the kernel does not take before launching: -1 for an unknown
// kv_kind, or when the CTA would need more than 227 KB or 512 threads.
extern "C" long long paged_attn_mla_smem_bytes(int kv_kind, int H, int rank, int rope, int bs) {
  const int es = kv_size(kv_kind);
  if (es == 0 || H <= 0 || rank <= 0 || rope < 0 || bs <= 0) return -1;
  const size_t smem = smem_bytes(es, H, rank, rope, bs);
  if (smem > (size_t)kMaxSmem || threads_for(H, rank) > kMaxThreads) return -1;
  return static_cast<long long>(smem);
}

// kv_kind: 0 = f32, 1 = bf16, 2 = posit16 (es 2), 3 = posit8 (es 2).
// chunk: table entries per split (1..32); with W > chunk the CTAs leave
// partials in scratch (B*H*S*(rank + 2) floats, S = ceil(W / chunk)) and
// the fold writes out.
extern "C" int paged_decode_attention_mla(int kv_kind, const void* q_lat, const void* q_rope,
                                          const void* c_arena, const void* r_arena,
                                          const void* tables, const void* apos,
                                          const void* lens, void* out, void* scratch, int B,
                                          int H, int rank, int rope, int nb, int bs, int W,
                                          int chunk, float scale, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (rank <= 0 || rope < 0 || bs <= 0 || W <= 0 || chunk <= 0 || chunk > kMaxChunk ||
      B > 0x7FFFFFFF / H)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_kind) {
    case 0: return launch<DecF32>(q_lat, q_rope, c_arena, r_arena, tables, apos, lens, out, scratch, B, H, rank, rope, nb, bs, W, chunk, scale, s);
    case 1: return launch<DecBF16>(q_lat, q_rope, c_arena, r_arena, tables, apos, lens, out, scratch, B, H, rank, rope, nb, bs, W, chunk, scale, s);
    case 2: return launch<DecPosit16>(q_lat, q_rope, c_arena, r_arena, tables, apos, lens, out, scratch, B, H, rank, rope, nb, bs, W, chunk, scale, s);
    case 3: return launch<DecPosit8>(q_lat, q_rope, c_arena, r_arena, tables, apos, lens, out, scratch, B, H, rank, rope, nb, bs, W, chunk, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
