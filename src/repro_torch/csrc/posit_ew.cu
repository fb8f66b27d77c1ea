// Fused elementwise PVU ops on posit patterns: vadd, vsub, vmul, vdiv.
//
// Replaces the Pallas TPU kernel ``repro/kernels/posit_ew.py``
// ``elementwise_2d`` (``_ew_kernel``): decode both operands to PIR, run
// the add/sub/mul/div datapath, encode once with the sticky bit -- no
// f32 round trip.  The arithmetic is ``pvu.cuh``, bit-identical to
// ``repro_torch/core/arith.py``.
//
// Bound on the H100: by operations for every op, narrowly for add, sub
// and mul.  A posit16 vmul moves 4 bytes an element (1.2 ps at 3.35
// TB/s) and its datapath needs some 57 integer operations (two decodes,
// the multiply, an encode: 1.7 ps at 33.5 T instructions a second, the
// card's issue rate); the dividers need 40 (nr3) or 132 (exact) for
// their core alone.  So the design keeps enough bytes in flight to feed
// the datapath, with little issue overhead around it:
//
// - 16-byte accesses.  A thread loads kUnroll 16-byte vectors of each
//   full operand (8 posit16, 4 posit32 or 16 posit8 patterns each), all
//   issued before the arithmetic, and stores 16-byte vectors of results.
//   A vector is taken a 32-bit word at a time, its patterns unrolled;
//   the words' loop unrolls too (the rotation is then register renames)
//   except for the exact divider, whose 33 steps would make the unrolled
//   text outgrow the instruction cache.
// - Most of an element's instructions are the datapath's integer ALU
//   work (decode, op, encode), and the ALU pipe issues at half the SM's
//   rate; ``pvu.cuh`` keeps it short (clamped funnel shifts, a 32-bit
//   encode).
// - Three operand modes, chosen by the wrapper, templated here: ``full``
//   (the output's shape), ``scalar`` (one pattern, decoded once per
//   thread before the loop) and ``row`` (a suffix of C patterns read at
//   i mod C, with the column carried as a 32-bit counter: no modulo per
//   element; the conv bias of (95 048, 64) + (64,)).  Nothing is
//   broadcast into memory.
// - Indexing: a 64-bit base per CTA chunk of kThreads * kUnroll vectors,
//   32-bit offsets inside it; a grid of at most 8 CTAs an SM strides over
//   the chunks.
// - Ragged edges in the kernel.  The vectors are aligned to the output;
//   the head before its first 16-byte boundary and the tail after its last
//   whole vector are done with scalar accesses by the grid's first
//   threads.  A full operand whose address is not 16-byte aligned with the
//   output's (a view at an odd element offset) is read with scalar loads
//   in the same loop.
//
// Plain C interface (loaded through ctypes); the entry returns the CUDA
// error code of its launch, 0 on success.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pvu.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;        // 16-byte vectors in flight per thread and operand
constexpr int kCtasPerSm = 8;     // 2 048 threads: an SM's thread slots

enum Mode { kFull = 0, kScalar = 1, kRow = 2 };

template <typename P>
struct Operand {
  const P* p;
  int cols;       // kRow: the suffix's element count C
  int vec;        // kFull: 16-byte aligned where the output's vectors are
};

template <typename P>
struct Args {
  Operand<P> a, b;
  P* out;
  long long n;    // output elements
  long long nvec; // whole 16-byte output vectors after the head
  int head;       // elements before the output's first 16-byte boundary
};

// pattern k of a 32-bit word
template <typename P>
__device__ __forceinline__ uint32_t field(uint32_t w, int k) {
  if constexpr (sizeof(P) == 4) {
    return w;
  } else {
    return (w >> (8 * sizeof(P) * k)) & ((1u << (8 * sizeof(P))) - 1u);
  }
}

template <typename P>
__device__ __forceinline__ void load_vec(const P* p, bool aligned, uint32_t (&w)[4]) {
  if (aligned) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
    constexpr int kV = 16 / static_cast<int>(sizeof(P));
    constexpr int kPer = 4 / static_cast<int>(sizeof(P));
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = 0u;
#pragma unroll
    for (int k = 0; k < kV; ++k)
      w[k / kPer] |= static_cast<uint32_t>(__ldg(p + k)) << (8 * sizeof(P) * (k % kPer));
  }
}

// the operand at output element i (head, tail and non-vector use)
template <int N, int ES, int M, typename P>
__device__ __forceinline__ pvu::Pir operand_at(const Operand<P>& o, const pvu::Pir& s,
                                               long long i) {
  if constexpr (M == kScalar) {
    return s;
  } else {
    return pvu::decode<N, ES>(__ldg(o.p + (M == kRow ? i % o.cols : i)));
  }
}

template <int N, int ES, int OP, int MA, int MB, typename P>
__global__ void __launch_bounds__(kThreads) ew_kernel(const Args<P> args) {
  constexpr int kV = 16 / static_cast<int>(sizeof(P));
  constexpr int kPer = 4 / static_cast<int>(sizeof(P));
  constexpr long long kChunk = static_cast<long long>(kThreads) * kUnroll;  // vectors
  // the exact divider's 33 steps: its word loop stays rolled, or the
  // kernel's text outgrows the instruction cache
  constexpr int kWordUnroll = OP == pvu::kDivExact ? 1 : 4;
  const Operand<P> a = args.a, b = args.b;
  const int tid = threadIdx.x;
  pvu::Pir sa{}, sb{};
  if constexpr (MA == kScalar) sa = pvu::decode<N, ES>(__ldg(a.p));
  if constexpr (MB == kScalar) sb = pvu::decode<N, ES>(__ldg(b.p));

  // the ragged head and tail, one element a thread
  {
    const long long body_end = args.head + args.nvec * kV;
    const long long t = static_cast<long long>(blockIdx.x) * kThreads + tid;
    if (t < args.head + (args.n - body_end)) {
      const long long i = t < args.head ? t : body_end + (t - args.head);
      args.out[i] = static_cast<P>(pvu::elementwise_pir<N, ES, OP>(
          operand_at<N, ES, MA>(a, sa, i), operand_at<N, ES, MB>(b, sb, i)));
    }
  }

  // row operands: the column of each vector's first element, advanced by
  // the grid's stride at every chunk (one compare and subtract)
  const long long stride = static_cast<long long>(gridDim.x) * kChunk;
  int col_a[kUnroll], col_b[kUnroll];
  int step_a = 0, step_b = 0;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long e = args.head + (blockIdx.x * kChunk + u * kThreads + tid) * kV;
    col_a[u] = MA == kRow ? static_cast<int>(e % a.cols) : 0;
    col_b[u] = MB == kRow ? static_cast<int>(e % b.cols) : 0;
  }
  if constexpr (MA == kRow) step_a = static_cast<int>((stride * kV) % a.cols);
  if constexpr (MB == kRow) step_b = static_cast<int>((stride * kV) % b.cols);

  for (long long v0 = blockIdx.x * kChunk; v0 < args.nvec; v0 += stride) {
    const long long e0 = args.head + v0 * kV;       // the chunk's 64-bit base
    const P* __restrict__ pa = a.p + (MA == kFull ? e0 : 0);
    const P* __restrict__ pb = b.p + (MB == kFull ? e0 : 0);
    P* __restrict__ po = args.out + e0;
    const int live = static_cast<int>(args.nvec - v0 < kChunk ? args.nvec - v0 : kChunk);
    uint32_t wa[kUnroll][4], wb[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {             // every load in flight first
      const int off = u * kThreads + tid;           // vectors from the base
      if (off < live) {
        if constexpr (MA == kFull) load_vec(pa + off * kV, a.vec != 0, wa[u]);
        if constexpr (MB == kFull) load_vec(pb + off * kV, b.vec != 0, wb[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int off = u * kThreads + tid;
      if (off < live) {
        uint32_t a0 = wa[u][0], a1 = wa[u][1], a2 = wa[u][2], a3 = wa[u][3];
        uint32_t b0 = wb[u][0], b1 = wb[u][1], b2 = wb[u][2], b3 = wb[u][3];
        uint32_t o0 = 0u, o1 = 0u, o2 = 0u, o3 = 0u;
        int ca = col_a[u], cb = col_b[u];
        // a word a trip, its kPer elements unrolled, the words rotated
        // down (register renames where the trips unroll)
#pragma unroll kWordUnroll
        for (int j = 0; j < 4; ++j) {
          uint32_t o = 0u;
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            pvu::Pir x, y;
            if constexpr (MA == kFull) x = pvu::decode<N, ES>(field<P>(a0, k));
            if constexpr (MA == kScalar) x = sa;
            if constexpr (MA == kRow) {
              x = pvu::decode<N, ES>(__ldg(a.p + ca));
              ca = ca + 1 == a.cols ? 0 : ca + 1;
            }
            if constexpr (MB == kFull) y = pvu::decode<N, ES>(field<P>(b0, k));
            if constexpr (MB == kScalar) y = sb;
            if constexpr (MB == kRow) {
              y = pvu::decode<N, ES>(__ldg(b.p + cb));
              cb = cb + 1 == b.cols ? 0 : cb + 1;
            }
            o |= pvu::elementwise_pir<N, ES, OP>(x, y) << (8 * sizeof(P) * k);
          }
          a0 = a1;
          a1 = a2;
          a2 = a3;
          b0 = b1;
          b1 = b2;
          b2 = b3;
          o0 = o1;
          o1 = o2;
          o2 = o3;
          o3 = o;
        }
        *reinterpret_cast<uint4*>(po + off * kV) = make_uint4(o0, o1, o2, o3);
      }
      if constexpr (MA == kRow) {
        col_a[u] += step_a;
        col_a[u] -= col_a[u] >= a.cols ? a.cols : 0;
      }
      if constexpr (MB == kRow) {
        col_b[u] += step_b;
        col_b[u] -= col_b[u] >= b.cols ? b.cols : 0;
      }
    }
  }
}

template <int N, int ES, int OP, int MA, int MB, typename P>
int launch_modes(const Args<P>& args, int sms, cudaStream_t s) {
  constexpr long long kChunk = static_cast<long long>(kThreads) * kUnroll;
  const long long chunks = (args.nvec + kChunk - 1) / kChunk;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 1) * kCtasPerSm;
  const unsigned grid = static_cast<unsigned>(chunks < 1 ? 1 : (chunks < cap ? chunks : cap));
  const auto kernel = ew_kernel<N, ES, OP, MA, MB, P>;
  kernel<<<grid, kThreads, 0, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int ES, int OP, typename P>
int launch_op(const Args<P>& args, int ma, int mb, int sms, cudaStream_t s) {
  if (ma == kFull && mb == kFull) return launch_modes<N, ES, OP, kFull, kFull, P>(args, sms, s);
  if (ma == kScalar && mb == kFull) return launch_modes<N, ES, OP, kScalar, kFull, P>(args, sms, s);
  if (ma == kFull && mb == kScalar) return launch_modes<N, ES, OP, kFull, kScalar, P>(args, sms, s);
  if (ma == kRow && mb == kFull) return launch_modes<N, ES, OP, kRow, kFull, P>(args, sms, s);
  if (ma == kFull && mb == kRow) return launch_modes<N, ES, OP, kFull, kRow, P>(args, sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int N, int ES, typename P>
int launch(int op, const void* a, int ma, int ca, const void* b, int mb, int cb, void* out,
           long long n, int sms, cudaStream_t s) {
  constexpr int kV = 16 / static_cast<int>(sizeof(P));
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  if (o % sizeof(P) != 0 || reinterpret_cast<uintptr_t>(a) % sizeof(P) != 0 ||
      reinterpret_cast<uintptr_t>(b) % sizeof(P) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if ((ma == kRow && (ca < 1 || n % ca != 0)) || (mb == kRow && (cb < 1 || n % cb != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args<P> args;
  long long head = static_cast<long long>((16 - o % 16) % 16 / sizeof(P));
  head = head < n ? head : n;
  args.head = static_cast<int>(head);
  args.nvec = (n - head) / kV;
  args.n = n;
  args.out = static_cast<P*>(out);
  // a full operand takes 16-byte loads where its element ``head`` is
  // 16-byte aligned, as the output's is
  const uintptr_t skip = static_cast<uintptr_t>(head) * sizeof(P);
  args.a = {static_cast<const P*>(a), ca, (reinterpret_cast<uintptr_t>(a) + skip) % 16 == 0};
  args.b = {static_cast<const P*>(b), cb, (reinterpret_cast<uintptr_t>(b) + skip) % 16 == 0};
  switch (op) {
    case pvu::kAdd: return launch_op<N, ES, pvu::kAdd, P>(args, ma, mb, sms, s);
    case pvu::kSub: return launch_op<N, ES, pvu::kSub, P>(args, ma, mb, sms, s);
    case pvu::kMul: return launch_op<N, ES, pvu::kMul, P>(args, ma, mb, sms, s);
    case pvu::kDivNr3: return launch_op<N, ES, pvu::kDivNr3, P>(args, ma, mb, sms, s);
    case pvu::kDivExact: return launch_op<N, ES, pvu::kDivExact, P>(args, ma, mb, sms, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// op: 0 add, 1 sub, 2 mul, 3 div nr3, 4 div exact.  Each operand comes
// with its mode (0 full: n elements; 1 scalar: one; 2 row: a suffix of
// ``cols`` elements read at i mod cols, cols dividing n); at most one
// operand is not full.  sms: the card's SM count (sizes the grid).
extern "C" int posit_elementwise(int nbits, int es, int op, const void* a, int mode_a,
                                 int cols_a, const void* b, int mode_b, int cols_b, void* out,
                                 long long n, int sms, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbits == 32 && es == 2)
    return launch<32, 2, uint32_t>(op, a, mode_a, cols_a, b, mode_b, cols_b, out, n, sms, s);
  if (nbits == 16 && es == 2)
    return launch<16, 2, uint16_t>(op, a, mode_a, cols_a, b, mode_b, cols_b, out, n, sms, s);
  if (nbits == 16 && es == 1)
    return launch<16, 1, uint16_t>(op, a, mode_a, cols_a, b, mode_b, cols_b, out, n, sms, s);
  if (nbits == 8 && es == 2)
    return launch<8, 2, uint8_t>(op, a, mode_a, cols_a, b, mode_b, cols_b, out, n, sms, s);
  if (nbits == 8 && es == 0)
    return launch<8, 0, uint8_t>(op, a, mode_a, cols_a, b, mode_b, cols_b, out, n, sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
