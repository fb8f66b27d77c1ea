// Posit codec kernels: f32 -> posit patterns (quantize) and back.
//
// Replaces the Pallas TPU kernels ``repro/kernels/posit_codec.py``
// ``quantize_2d`` / ``dequantize_2d`` (``_quant_kernel`` /
// ``_dequant_kernel``), elementwise over a flat buffer, templated on
// (nbits, es) for the five configs of ``core/types.py`` (posit32,
// posit16, posit8 with es = 2; posit16 es 1; posit8 es 0).  Both are
// bit-identical to ``core/convert.py``.
//
// Quantize.  Bound on the H100 by memory: it reads 4 B and writes 1-4 B
// an element (posit16: 6 B, 1.8 ps at 3.35 TB/s), and its encode
// (``posit_quant.cuh``: a shared-memory table entry per sign and
// exponent, one 32-bit rounding) is some ten integer instructions, under
// the bytes' time at the ALU pipe's 64 lanes an SM.  So the design keeps
// bytes in flight with little issue around them:
// - a persistent grid of 4 CTAs an SM, each filling its table once; a
//   thread issues four 16-byte source loads a trip (2 output vectors of
//   posit16, 4 of posit32, 1 of posit8) before it encodes any, and the
//   first trip's loads fly while the table fills;
// - 16-byte stores aligned to the output; the ragged head before its
//   first boundary and the tail after its last whole vector are scalar,
//   done by the grid's first threads; a source not 16-byte aligned with
//   the output's vectors (a view at an odd offset) is read an element at
//   a time in the same loop;
// - a 64-bit base per trip, 32-bit offsets inside it.
//
// Dequantize.  Bound by memory too: 2 B read and 4 B written an element
// at posit16 (1.8 ps at 3.35 TB/s; posit8 5 B, posit32 8 B).  Its decode
// is ``posit_narrow.cuh``'s for posits of at most 16 bits (exact and
// branch-free, a dozen integer instructions) and ``posit.cuh``'s
// ``to_f32`` for posit32.  The design:
// - one launch takes a job table of up to ``kDeqMaxJobs`` leaves (a
//   layer's K and V, or MLA's latent and RoPE key), each a source, an
//   output and a length, as a ``__grid_constant__`` parameter read at
//   static offsets; the grid strides over the jobs' chunks, each chunk
//   inside one job;
// - the output sets the vector: a lane decodes a unit of four patterns
//   (one 4-, 8- or 16-byte load) into one 16-byte f32 store, so that a
//   warp's store is 512 contiguous bytes (a 16-byte pattern load with two
//   or four stores a lane would put each warp store at a 32- or 64-byte
//   stride: half-sector writes);
// - a persistent grid of 8 CTAs an SM (32 registers a thread); a lane
//   issues a trip's unit loads (4 of posit8 or posit16, 2 of posit32:
//   16-32 bytes) before it decodes any;
// - the units are aligned to the source; the ragged head before its
//   first unit boundary and the tail after its last whole unit are
//   scalar, a warp of the first CTA a job; an output not 16-byte aligned
//   where the source's units are (a view at an odd offset) is stored an
//   element at a time in the same loop;
// - a 64-bit base per trip, 32-bit offsets inside it.
// An output mode rounds each value to nearest-even bf16 and widens it
// back to f32 (what the linear decode's einsums read after the cast to
// the compute dtype), in integer arithmetic: NaR's NaN 0x7FC00000 stays
// itself, as the reference's ``astype(bfloat16)`` keeps it.
//
// Plain C interface (loaded through ctypes); each entry returns the CUDA
// error code of its launch, 0 on success.
#include <cuda_runtime.h>
#include <stdint.h>

#include "posit.cuh"
#include "posit_narrow.cuh"
#include "posit_quant.cuh"

namespace {

constexpr int kThreads = 256;

constexpr int kQuantCtasPerSm = 4;  // 1 024 threads an SM: 64 KB of loads in flight

template <typename P>
struct QuantArgs {
  const uint32_t* x;  // f32 bits
  P* out;
  long long n;
  long long nvec;     // whole 16-byte output vectors after the head
  int head;           // elements before the output's first 16-byte boundary
  int xvec;           // the source is 16-byte aligned where the output's vectors are
};

template <int N, int ES, typename P>
__global__ void __launch_bounds__(kThreads, kQuantCtasPerSm)
quantize_kernel(const QuantArgs<P> a) {
  constexpr int kV = 16 / static_cast<int>(sizeof(P));  // patterns a vector
  constexpr int kU = static_cast<int>(sizeof(P));       // vectors a trip: 4 source loads
  constexpr long long kChunk = static_cast<long long>(kThreads) * kU;
  __shared__ posit::F32Entry lut[quant::kLutEntries];
  const int tid = threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kChunk;
  uint32_t w[kU][kV];
  // a trip's vectors from its 64-bit base v0, 32-bit offsets below ``live``
  auto live_from = [&](long long v0) {
    return static_cast<int>(a.nvec - v0 < kChunk ? a.nvec - v0 : kChunk);
  };
  auto load = [&](long long v0) {
    const uint32_t* px = a.x + a.head + v0 * kV;
    const int live = live_from(v0);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int off = u * kThreads + tid;
      if (off < live) quant::load_src<uint32_t, kV>(px + off * kV, a.xvec != 0, w[u]);
    }
  };
  auto store = [&](long long v0) {
    P* po = a.out + a.head + v0 * kV;
    const int live = live_from(v0);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int off = u * kThreads + tid;
      if (off < live)
        *reinterpret_cast<uint4*>(po + off * kV) = quant::encode_vec<N, ES, P, uint32_t>(lut, w[u]);
    }
  };

  long long v0 = static_cast<long long>(blockIdx.x) * kChunk;
  load(v0);                               // in flight while the table fills
  quant::fill_lut<N, ES>(lut);
  __syncthreads();
  // the ragged head and tail, one element a thread
  {
    const long long body_end = a.head + a.nvec * kV;
    const long long t = static_cast<long long>(blockIdx.x) * kThreads + tid;
    if (t < a.head + (a.n - body_end)) {
      const long long i = t < a.head ? t : body_end + (t - a.head);
      a.out[i] = static_cast<P>(quant::encode<N, ES>(lut, __ldg(a.x + i)));
    }
  }
  for (;;) {
    store(v0);
    v0 += stride;
    if (v0 >= a.nvec) break;
    load(v0);
  }
}

constexpr int kDeqCtasPerSm = 8;   // 2 048 threads an SM: 32-64 KB of loads in flight
constexpr int kDeqMaxJobs = 4;

// A unit: four patterns, loaded as one word of 4, 8 or 16 bytes, decoded
// into one 16-byte f32 vector
template <typename P> struct Unit;
template <> struct Unit<uint8_t> { using T = uint32_t; };
template <> struct Unit<uint16_t> { using T = unsigned long long; };
template <> struct Unit<uint32_t> { using T = uint4; };

template <typename P>
constexpr int kDeqU = sizeof(P) == 4 ? 2 : 4;  // unit loads a trip: 16-32 B
template <typename P>
constexpr long long kDeqChunk = static_cast<long long>(kThreads) * kDeqU<P>;  // units a trip

struct DeqJob {
  const void* src;   // patterns, aligned to a unit from element ``head`` on
  float* out;
  long long n;
  long long nunit;   // whole units after the head
  long long chunk0;  // the job's first chunk in the launch
  int head;          // elements before the source's first unit boundary
  int ovec;          // the output is 16-byte aligned where the source's units are
};

struct DeqJobs {
  DeqJob job[kDeqMaxJobs];
  long long chunks;  // all jobs' chunks
  int n_jobs;
};

// the f32 bits of pattern p (its low N bits; the bits above are
// ignored), rounded to nearest-even bf16 with kBf16
template <int N, int ES, bool kBf16>
__device__ __forceinline__ uint32_t decode_bits(uint32_t p) {
  uint32_t u;
  if constexpr (N <= 16) {
    u = posit::f32_bits(posit::to_f32_narrow<N, ES>(p));
  } else {
    u = posit::f32_bits(posit::to_f32<N, ES>(p));
  }
  if constexpr (kBf16) u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
  return u;
}

// the f32 bits of a unit's four patterns
template <int N, int ES, bool kBf16, typename T>
__device__ __forceinline__ uint4 decode_unit(const T& v) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(decode_bits<N, ES, kBf16>(v), decode_bits<N, ES, kBf16>(v >> 8),
                      decode_bits<N, ES, kBf16>(v >> 16), decode_bits<N, ES, kBf16>(v >> 24));
  } else if constexpr (sizeof(T) == 8) {
    const uint32_t lo = static_cast<uint32_t>(v), hi = static_cast<uint32_t>(v >> 32);
    return make_uint4(decode_bits<N, ES, kBf16>(lo), decode_bits<N, ES, kBf16>(lo >> 16),
                      decode_bits<N, ES, kBf16>(hi), decode_bits<N, ES, kBf16>(hi >> 16));
  } else {
    return make_uint4(decode_bits<N, ES, kBf16>(v.x), decode_bits<N, ES, kBf16>(v.y),
                      decode_bits<N, ES, kBf16>(v.z), decode_bits<N, ES, kBf16>(v.w));
  }
}

// job ``k`` of the table, read at static offsets of the parameter
__device__ __forceinline__ DeqJob job_at(const DeqJobs& jobs, int k) {
  DeqJob jb = jobs.job[0];
#pragma unroll
  for (int i = 1; i < kDeqMaxJobs; ++i)
    if (i == k) jb = jobs.job[i];
  return jb;
}

template <int N, int ES, typename P, bool kBf16>
__global__ void __launch_bounds__(kThreads, kDeqCtasPerSm)
dequantize_kernel(const __grid_constant__ DeqJobs jobs) {
  using T = typename Unit<P>::T;
  constexpr int kU = kDeqU<P>;
  constexpr long long kChunk = kDeqChunk<P>;
  const int tid = threadIdx.x;
  // the ragged heads and tails (under 4 elements each): a warp of the
  // first CTA a job
  if (blockIdx.x == 0 && tid < jobs.n_jobs * 32) {
    const DeqJob jb = job_at(jobs, tid >> 5);
    const int i = tid & 31;
    const long long tail_at = jb.head + jb.nunit * 4;
    if (i < jb.head + (jb.n - tail_at)) {
      const long long k = i < jb.head ? i : tail_at + (i - jb.head);
      const uint32_t p = static_cast<uint32_t>(__ldg(static_cast<const P*>(jb.src) + k));
      jb.out[k] = posit::bits_f32(decode_bits<N, ES, kBf16>(p));
    }
  }
  for (long long c = blockIdx.x; c < jobs.chunks; c += gridDim.x) {
    // the chunk's job: the last one whose chunks start at or before c
    DeqJob jb = jobs.job[0];
#pragma unroll
    for (int i = 1; i < kDeqMaxJobs; ++i)
      if (i < jobs.n_jobs && c >= jobs.job[i].chunk0) jb = jobs.job[i];
    // the trip's 64-bit base, 32-bit offsets below ``live``
    const long long u0 = (c - jb.chunk0) * kChunk;
    const int live = static_cast<int>(jb.nunit - u0 < kChunk ? jb.nunit - u0 : kChunk);
    const T* ps = reinterpret_cast<const T*>(static_cast<const P*>(jb.src) + jb.head) + u0;
    float* po = jb.out + jb.head + u0 * 4;
    T w[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int off = u * kThreads + tid;
      if (off < live) w[u] = __ldg(ps + off);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int off = u * kThreads + tid;
      if (off >= live) continue;
      const uint4 o = decode_unit<N, ES, kBf16>(w[u]);
      if (jb.ovec) {
        reinterpret_cast<uint4*>(po)[off] = o;   // a warp's stores: 512 contiguous bytes
      } else {
        float* dst = po + off * 4;
        dst[0] = posit::bits_f32(o.x);
        dst[1] = posit::bits_f32(o.y);
        dst[2] = posit::bits_f32(o.z);
        dst[3] = posit::bits_f32(o.w);
      }
    }
  }
}

template <int N, int ES, typename P>
int quantize(const void* x, void* out, long long n, int sms, cudaStream_t s) {
  constexpr int kV = 16 / static_cast<int>(sizeof(P));
  constexpr long long kChunk = static_cast<long long>(kThreads) * sizeof(P);
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  const uintptr_t xi = reinterpret_cast<uintptr_t>(x);
  if (o % sizeof(P) != 0 || xi % 4 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  QuantArgs<P> a;
  long long head = static_cast<long long>((16 - o % 16) % 16 / sizeof(P));
  head = head < n ? head : n;
  a.x = static_cast<const uint32_t*>(x);
  a.out = static_cast<P*>(out);
  a.n = n;
  a.head = static_cast<int>(head);
  a.nvec = (n - head) / kV;
  a.xvec = (xi + static_cast<uintptr_t>(head) * 4) % 16 == 0;
  const long long chunks = (a.nvec + kChunk - 1) / kChunk;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 1) * kQuantCtasPerSm;
  const unsigned grid = static_cast<unsigned>(chunks < 1 ? 1 : (chunks < cap ? chunks : cap));
  quantize_kernel<N, ES, P><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The job table of n_jobs leaves of P patterns (host arrays), or an error
// code: a source not aligned to its pattern type, or an output not
// aligned to f32, is a misaligned address.
template <typename P>
int fill_jobs(DeqJobs& jobs, int n_jobs, const void* const* srcs, void* const* outs,
              const long long* ns) {
  constexpr uintptr_t kUnitBytes = 4 * sizeof(P);
  jobs.n_jobs = n_jobs;
  jobs.chunks = 0;
  for (int j = 0; j < kDeqMaxJobs; ++j) {
    DeqJob& jb = jobs.job[j];
    jb = DeqJob{nullptr, nullptr, 0, 0, jobs.chunks, 0, 0};
    if (j >= n_jobs) continue;
    const uintptr_t si = reinterpret_cast<uintptr_t>(srcs[j]);
    const uintptr_t oi = reinterpret_cast<uintptr_t>(outs[j]);
    if (si % sizeof(P) != 0 || oi % 4 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
    long long head = static_cast<long long>((kUnitBytes - si % kUnitBytes) % kUnitBytes /
                                            sizeof(P));
    head = head < ns[j] ? head : ns[j];
    jb.src = srcs[j];
    jb.out = static_cast<float*>(outs[j]);
    jb.n = ns[j];
    jb.head = static_cast<int>(head);
    jb.nunit = (ns[j] - head) / 4;
    jb.ovec = (oi + static_cast<uintptr_t>(head) * 4) % 16 == 0;
    jobs.chunks += (jb.nunit + kDeqChunk<P> - 1) / kDeqChunk<P>;
  }
  return 0;
}

template <int N, int ES, typename P>
int dequantize(int round_bf16, int n_jobs, const void* const* srcs, void* const* outs,
               const long long* ns, int sms, cudaStream_t s) {
  DeqJobs jobs;
  const int rc = fill_jobs<P>(jobs, n_jobs, srcs, outs, ns);
  if (rc != 0) return rc;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 1) * kDeqCtasPerSm;
  const unsigned grid =
      static_cast<unsigned>(jobs.chunks < 1 ? 1 : (jobs.chunks < cap ? jobs.chunks : cap));
  if (round_bf16) {
    dequantize_kernel<N, ES, P, true><<<grid, kThreads, 0, s>>>(jobs);
  } else {
    dequantize_kernel<N, ES, P, false><<<grid, kThreads, 0, s>>>(jobs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sms: the card's SM count (sizes the persistent grid)
extern "C" int posit_quantize(int nbits, int es, const void* x, void* out, long long n,
                              int sms, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbits == 32 && es == 2) return quantize<32, 2, uint32_t>(x, out, n, sms, s);
  if (nbits == 16 && es == 2) return quantize<16, 2, uint16_t>(x, out, n, sms, s);
  if (nbits == 16 && es == 1) return quantize<16, 1, uint16_t>(x, out, n, sms, s);
  if (nbits == 8 && es == 2) return quantize<8, 2, uint8_t>(x, out, n, sms, s);
  if (nbits == 8 && es == 0) return quantize<8, 0, uint8_t>(x, out, n, sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// round_bf16: 0 = f32 values, 1 = f32 values rounded to nearest-even bf16.
// srcs, outs and ns are host arrays of n_jobs (1..4) leaves: ns[j]
// patterns in, as many f32 out.  sms: the card's SM count.
extern "C" int posit_dequantize(int nbits, int es, int round_bf16, int n_jobs,
                                const void* const* srcs, void* const* outs, const long long* ns,
                                int sms, void* stream) {
  if (n_jobs < 1 || n_jobs > kDeqMaxJobs) return static_cast<int>(cudaErrorInvalidValue);
  long long total = 0;
  for (int j = 0; j < n_jobs; ++j) {
    if (ns[j] < 0) return static_cast<int>(cudaErrorInvalidValue);
    total += ns[j];
  }
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbits == 32 && es == 2)
    return dequantize<32, 2, uint32_t>(round_bf16, n_jobs, srcs, outs, ns, sms, s);
  if (nbits == 16 && es == 2)
    return dequantize<16, 2, uint16_t>(round_bf16, n_jobs, srcs, outs, ns, sms, s);
  if (nbits == 16 && es == 1)
    return dequantize<16, 1, uint16_t>(round_bf16, n_jobs, srcs, outs, ns, sms, s);
  if (nbits == 8 && es == 2)
    return dequantize<8, 2, uint8_t>(round_bf16, n_jobs, srcs, outs, ns, sms, s);
  if (nbits == 8 && es == 0)
    return dequantize<8, 0, uint8_t>(round_bf16, n_jobs, srcs, outs, ns, sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
