// Row-wise posit dot product through the quire-lite: (R, L) x (R, L) -> (R,).
//
// Replaces the Pallas TPU kernel ``repro/kernels/posit_dot.py``
// ``vpdot_rows`` (``_vpdot_kernel``): per tile of MAX_DOT_LENGTH = 4096
// elements, counted from element 0, the products are aligned to the
// tile's largest product exponent, floored and summed mod 2^128; the
// tile states fold in order (``quire_combine``) and the result rounds
// once.  The TPU walks the K tiles as a sequential grid dimension with
// the state in VMEM scratch; here a loop over the tiles in one CTA takes
// its place.
//
// Why two passes per tile: every product is floored against the tile's
// maximum exponent, so none can be placed before that maximum is known
// (pass 1: decode, max; pass 2: place with ``pvu::place_add``, the
// placement ``posit_qgemm.cu`` uses, so pgemm == dot by construction).
// Within a tile the sum is exact mod 2^128 and the sticky an OR, so the
// lanes may add in any order.
//
// Bound on the H100: bytes at the paper's conv (65 536 dots of 147
// posit32: 77 MB, 0.023 ms); its operations (two decodes and a placement
// a product, 38) take half of that at the card's issue rate.  The design:
//
// - Rows staged in shared memory.  A CTA copies its span of both
//   operands -- a block of whole rows, or one row's quire tile -- with
//   16-byte ``cp.async``; the ragged head and tail of a span (rows of
//   147 posit32 patterns do not start on 16 bytes) are loaded by one
//   thread an element and stored once the buffer is needed.  A row longer
//   than a tile is staged tile by tile, the next tile in flight while the
//   current one is reduced (two buffers).
// - G lanes a row, chosen by the wrapper from L and templated: 8 lanes
//   (L <= 80), 16 (L <= 160) and 32 (L <= 320) for short rows, so the
//   max and sum shuffles take log2 G rounds, few lanes sit idle, a CTA's
//   staging and rounding serve 256 / G rows, and each lane keeps its at
//   most 10 products decoded in registers between the passes (every
//   pattern decoded once; the conv's 147 take 16 lanes); a whole CTA of
//   256 lanes for longer rows, which decodes again from shared memory in
//   pass 2 and reduces across warps through shared memory.
// - A row block's states go through shared memory and are rounded by
//   one lane a row of the first warp, so the block pays one
//   ``quire_finalize`` of warp issue, not one a row, and its outputs are
//   stored together.
// - The first tile's state is the row's state (folding into the empty
//   state is the identity), so a one-tile row skips ``quire_combine``.
//
// Plain C interface (loaded through ctypes); the entry returns the CUDA
// error code of its launch, 0 on success.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "pvu.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCache = 10;            // products a lane keeps decoded (G <= 32)
constexpr int kTile = pvu::kMaxDotLength;
constexpr unsigned kFull = 0xFFFFFFFFu;

// 16-byte global -> shared copies in flight, their group commit and wait
// (synchronous copies in a host build)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
#else
  memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

__device__ __forceinline__ void cp_async_wait1() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 1;\n" ::);
#endif
}

__device__ __forceinline__ uint64_t shfl_xor64(uint64_t v, int off) {
  const uint32_t lo = __shfl_xor_sync(kFull, static_cast<uint32_t>(v), off);
  const uint32_t hi = __shfl_xor_sync(kFull, static_cast<uint32_t>(v >> 32), off);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// The ragged head or tail element of a staged span a thread holds in a
// register until it stores it: ``at`` is its byte in the buffer, -1 none.
template <typename P>
struct Frag {
  P v;
  int at;
};

// Elements [g, g + n) of x into the buffer ``dst`` (16-byte aligned):
// element i lands at byte (address of x + g) % 16 + i * sizeof(P), so the
// whole 16-byte granules of the span go by cp.async.  Their head and tail
// (fewer than 16 bytes each) are loaded by threads [lane0, lane0 + 32),
// one element each, into the returned fragment.
template <typename P>
__device__ __forceinline__ Frag<P> stage(unsigned char* dst, const P* __restrict__ x,
                                         long long g, int n, int tid, int lane0) {
  constexpr int kV = 16 / static_cast<int>(sizeof(P));
  const P* src = x + g;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) % 16);
  int nh = (16 - mis) % 16 / static_cast<int>(sizeof(P));
  nh = nh < n ? nh : n;
  const int nv = (n - nh) / kV;                      // whole granules
  const int nt = n - nh - nv * kV;
  unsigned char* vdst = dst + mis + nh * static_cast<int>(sizeof(P));
  for (int k = tid; k < nv; k += kThreads) cp_async16(vdst + 16 * k, src + nh + k * kV);
  Frag<P> f;
  f.at = -1;
  const int j = tid - lane0;
  if (j >= 0 && j < nh + nt) {
    const int i = j < nh ? j : nh + nv * kV + (j - nh);
    f.v = src[i];
    f.at = mis + i * static_cast<int>(sizeof(P));
  }
  return f;
}

template <typename P>
__device__ __forceinline__ void store_frag(unsigned char* dst, const Frag<P>& f) {
  if (f.at >= 0) *reinterpret_cast<P*>(dst + f.at) = f.v;
}

// G lanes a row, a block of kThreads / G rows; the row's one tile
template <int N, int ES, int G, typename P>
__device__ __forceinline__ void dot_rows_tile(const P* xa, const P* xb, P* __restrict__ out,
                                              int row0, int nrows, int len) {
  constexpr bool kNarrow = N <= 16;
  const int grp = threadIdx.x / G, gl = threadIdx.x % G;
  const bool live = grp < nrows;                     // rows past the end place nothing
  const P* ra = xa + grp * len;
  const P* rb = xb + grp * len;
  uint32_t ca[kCache], cb[kCache], cn[kCache];
  int ce[kCache];
  int m = pvu::kExpSentinel;
  uint32_t nar = 0u;
#pragma unroll
  for (int c = 0; c < kCache; ++c) {                 // pass 1: decode once, max
    ca[c] = 0u;
    cb[c] = 0u;
    cn[c] = 0u;
    ce[c] = 0;
    const int i = gl + c * G;
    if (c * G < len && live && i < len) {
      const pvu::Pir pa = pvu::decode<N, ES>(ra[i]), pb = pvu::decode<N, ES>(rb[i]);
      ca[c] = pvu::place_sig<kNarrow>(pa.sig);
      cb[c] = pvu::place_sig<kNarrow>(pb.sig);
      ce[c] = pa.exp + pb.exp;
      cn[c] = pa.sign ^ pb.sign;
      const int e = pvu::product_exp(pa, pb);
      m = e > m ? e : m;
      nar |= (pa.nar || pb.nar) ? 1u : 0u;
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const int o = __shfl_xor_sync(kFull, m, off);
    m = o > m ? o : m;
    nar |= __shfl_xor_sync(kFull, nar, off);
  }
  pvu::TileSum sum = pvu::tile_sum_empty();
#pragma unroll
  for (int c = 0; c < kCache; ++c)                   // pass 2: place (zero sigs add nothing)
    if (c * G < len) pvu::place_add<kNarrow>(&sum, ca[c], cb[c], m - ce[c], cn[c]);
  const pvu::u128 v = sum.acc + sum.ones;
  uint64_t lo = static_cast<uint64_t>(v), hi = static_cast<uint64_t>(v >> 64);
  uint32_t st = sum.sticky;
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const uint64_t lo2 = shfl_xor64(lo, off), hi2 = shfl_xor64(hi, off);
    st |= __shfl_xor_sync(kFull, st, off);
    const uint64_t s = lo + lo2;
    hi = hi + hi2 + (s < lo ? 1ull : 0ull);
    lo = s;
  }
  // the rows' states to shared memory, rounded by one lane each of the
  // first warp (one finalize of warp issue for the CTA's rows, not one a
  // row) and stored together
  constexpr int kRows = kThreads / G;
  __shared__ uint64_t q_lo[kRows], q_hi[kRows];
  __shared__ int q_m[kRows];
  __shared__ uint32_t q_f[kRows];
  if (gl == 0) {
    q_lo[grp] = lo;
    q_hi[grp] = hi;
    q_m[grp] = m;
    q_f[grp] = st | (nar << 1);
  }
  __syncthreads();
  if (threadIdx.x < nrows) {
    const int i = threadIdx.x;
    pvu::Quire q;
    q.acc = (static_cast<pvu::u128>(q_hi[i]) << 64) | q_lo[i];
    q.m_exp = q_m[i];
    q.sticky = q_f[i] & 1u;
    q.nar = (q_f[i] >> 1) != 0u;
    out[row0 + i] = static_cast<P>(pvu::quire_finalize<N, ES>(q));
  }
}

// The whole CTA on one tile of one row; the row's state ``s`` lives in
// thread 0, which folds the tile in and, after the last, rounds.
template <int N, int ES, typename P>
__device__ __forceinline__ void dot_cta_tile(const P* xa, const P* xb, int n, int t, bool last,
                                             pvu::Quire* s, P* __restrict__ out_row) {
  constexpr bool kNarrow = N <= 16;
  __shared__ int red_m[kWarps];
  __shared__ uint32_t red_nar[kWarps], red_st[kWarps];
  __shared__ uint64_t red_lo[kWarps], red_hi[kWarps];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int m = pvu::kExpSentinel;
  uint32_t nar = 0u;
  for (int i = tid; i < n; i += kThreads) {          // pass 1: the tile's max
    const pvu::Pir pa = pvu::decode<N, ES>(xa[i]), pb = pvu::decode<N, ES>(xb[i]);
    const int e = pvu::product_exp(pa, pb);
    m = e > m ? e : m;
    nar |= (pa.nar || pb.nar) ? 1u : 0u;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int o = __shfl_xor_sync(kFull, m, off);
    m = o > m ? o : m;
    nar |= __shfl_xor_sync(kFull, nar, off);
  }
  if (lane == 0) {
    red_m[warp] = m;
    red_nar[warp] = nar;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    m = red_m[w] > m ? red_m[w] : m;
    nar |= red_nar[w];
  }
  pvu::TileSum sum = pvu::tile_sum_empty();
  for (int i = tid; i < n; i += kThreads) {          // pass 2: decode again, place
    const pvu::Pir pa = pvu::decode<N, ES>(xa[i]), pb = pvu::decode<N, ES>(xb[i]);
    pvu::place_add<kNarrow>(&sum, pvu::place_sig<kNarrow>(pa.sig),
                            pvu::place_sig<kNarrow>(pb.sig), m - (pa.exp + pb.exp),
                            pa.sign ^ pb.sign);
  }
  const pvu::u128 v = sum.acc + sum.ones;
  uint64_t lo = static_cast<uint64_t>(v), hi = static_cast<uint64_t>(v >> 64);
  uint32_t st = sum.sticky;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const uint64_t lo2 = shfl_xor64(lo, off), hi2 = shfl_xor64(hi, off);
    st |= __shfl_xor_sync(kFull, st, off);
    const uint64_t s2 = lo + lo2;
    hi = hi + hi2 + (s2 < lo ? 1ull : 0ull);
    lo = s2;
  }
  if (lane == 0) {                                   // (a warp may get here while
    red_lo[warp] = lo;                               // others still read red_nar)
    red_hi[warp] = hi;
    red_st[warp] = st;
  }
  __syncthreads();
  if (tid == 0) {
    pvu::Quire q;
    q.acc = 0;
    q.sticky = 0u;
    for (int w = 0; w < kWarps; ++w) {
      q.acc += (static_cast<pvu::u128>(red_hi[w]) << 64) | red_lo[w];
      q.sticky |= red_st[w];
    }
    q.m_exp = m;
    q.nar = nar != 0u;
    *s = t == 0 ? q : pvu::quire_combine(*s, q);
    if (last) *out_row = static_cast<P>(pvu::quire_finalize<N, ES>(*s));
  }
}

// G <= 32: a CTA reduces kThreads / G whole rows (L <= kCache * G) from
// one staged span.  G == kThreads: a CTA reduces one row, tile by tile.
template <int N, int ES, int G, typename P>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const P* __restrict__ a, const P* __restrict__ b, P* __restrict__ out, int rows,
           int len, int buf_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kRowBlock = G <= 32;
  constexpr int kRows = kRowBlock ? kThreads / G : 1;
  const int tid = threadIdx.x;
  const int row0 = static_cast<int>(blockIdx.x) * kRows;
  const int nrows = rows - row0 < kRows ? rows - row0 : kRows;
  const long long base = static_cast<long long>(row0) * len;    // the CTA's 64-bit base
  const int tiles = kRowBlock ? 1 : (len + kTile - 1) / kTile;
  // tile t: elements [base + t * kTile, + span) of both operands, in
  // buffer pair t % 2
  const auto span = [&](int t) {
    return kRowBlock ? nrows * len : (len - t * kTile < kTile ? len - t * kTile : kTile);
  };
  const auto buf = [&](int t, int o) { return smem + ((t & 1) * 2 + o) * buf_bytes; };
  Frag<P> fa = stage(buf(0, 0), a, base, span(0), tid, 0);
  Frag<P> fb = stage(buf(0, 1), b, base, span(0), tid, 32);
  cp_async_commit();
  pvu::Quire s = pvu::quire_empty();
  for (int t = 0; t < tiles; ++t) {
    store_frag(buf(t, 0), fa);
    store_frag(buf(t, 1), fb);
    if (t + 1 < tiles) {                             // the next tile in flight
      const long long g = base + static_cast<long long>(t + 1) * kTile;
      fa = stage(buf(t + 1, 0), a, g, span(t + 1), tid, 0);
      fb = stage(buf(t + 1, 1), b, g, span(t + 1), tid, 32);
    }
    cp_async_commit();
    cp_async_wait1();                                // tile t's copies have landed
    __syncthreads();
    const long long g = base + static_cast<long long>(t) * kTile;
    const P* xa = reinterpret_cast<const P*>(
        buf(t, 0) + reinterpret_cast<uintptr_t>(a + g) % 16);
    const P* xb = reinterpret_cast<const P*>(
        buf(t, 1) + reinterpret_cast<uintptr_t>(b + g) % 16);
    if constexpr (kRowBlock) {
      dot_rows_tile<N, ES, G, P>(xa, xb, out, row0, nrows, len);
    } else {
      dot_cta_tile<N, ES, P>(xa, xb, span(t), t, t + 1 == tiles, &s, out + row0);
    }
    __syncthreads();                                 // buffer pair t % 2 free again
  }
}

// bytes of one operand's buffer: the largest span and its misalignment
template <typename P>
int buf_bytes_for(int span) {
  return (span * static_cast<int>(sizeof(P)) + 15 + 15) / 16 * 16;
}

template <int N, int ES, int G, typename P>
int launch_g(const void* a, const void* b, void* out, int rows, int len, cudaStream_t s) {
  constexpr bool kRowBlock = G <= 32;
  constexpr int kRows = kRowBlock ? kThreads / G : 1;
  if (kRowBlock && len > kCache * G) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = kRowBlock ? 1 : (len + kTile - 1) / kTile;
  const int span = kRowBlock ? kRows * len : (len < kTile ? len : kTile);
  const int buf = buf_bytes_for<P>(span);
  const size_t smem = static_cast<size_t>(tiles > 1 ? 2 : 1) * 2 * buf;
  const auto kernel = dot_kernel<N, ES, G, P>;
  static bool opted_in = false;                      // the largest buffers, once
  if (!kRowBlock && !opted_in) {
    const int most = 2 * 2 * buf_bytes_for<P>(kTile);
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const unsigned grid = static_cast<unsigned>((rows + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const P*>(a), static_cast<const P*>(b),
                                      static_cast<P*>(out), rows, len, buf);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int ES, typename P>
int launch(const void* a, const void* b, void* out, int rows, int len, int group,
           cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(a) % sizeof(P) != 0 ||
      reinterpret_cast<uintptr_t>(b) % sizeof(P) != 0 ||
      reinterpret_cast<uintptr_t>(out) % sizeof(P) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch (group) {
    case 8: return launch_g<N, ES, 8, P>(a, b, out, rows, len, s);
    case 16: return launch_g<N, ES, 16, P>(a, b, out, rows, len, s);
    case 32: return launch_g<N, ES, 32, P>(a, b, out, rows, len, s);
    case kThreads: return launch_g<N, ES, kThreads, P>(a, b, out, rows, len, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// a, b: (rows, len) contiguous patterns; out: (rows,).  len >= 1.
// group: lanes a row, 8, 16 or 32 (len <= 10 * group) or 256 (any len).
extern "C" int posit_dot_rows(int nbits, int es, const void* a, const void* b, void* out,
                              long long rows, long long len, int group, void* stream) {
  if (rows <= 0) return 0;
  if (len <= 0 || rows > 0x7FFFFFFFLL || len > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(rows), l = static_cast<int>(len);
  if (nbits == 32 && es == 2) return launch<32, 2, uint32_t>(a, b, out, r, l, group, s);
  if (nbits == 16 && es == 2) return launch<16, 2, uint16_t>(a, b, out, r, l, group, s);
  if (nbits == 16 && es == 1) return launch<16, 1, uint16_t>(a, b, out, r, l, group, s);
  if (nbits == 8 && es == 2) return launch<8, 2, uint8_t>(a, b, out, r, l, group, s);
  if (nbits == 8 && es == 0) return launch<8, 0, uint8_t>(a, b, out, r, l, group, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
