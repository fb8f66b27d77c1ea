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
// Dequantize: one thread per element, grid-stride, ``posit.cuh``'s
// ``to_f32``.
//
// Plain C interface (loaded through ctypes); each entry returns the CUDA
// error code of its launch, 0 on success.
#include <cuda_runtime.h>
#include <stdint.h>

#include "posit.cuh"
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

template <int N, int ES, typename P>
__global__ void dequantize_kernel(const P* __restrict__ p, float* __restrict__ out,
                                  long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = posit::to_f32<N, ES>(static_cast<uint32_t>(p[i]));
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 64;  // enough waves to fill 132 SMs
  return static_cast<int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
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

template <int N, int ES, typename P>
int dequantize(const void* p, void* out, long long n, cudaStream_t s) {
  dequantize_kernel<N, ES, P><<<grid_for(n), kThreads, 0, s>>>(
      static_cast<const P*>(p), static_cast<float*>(out), n);
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

extern "C" int posit_dequantize(int nbits, int es, const void* p, void* out, long long n,
                                void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbits == 32 && es == 2) return dequantize<32, 2, uint32_t>(p, out, n, s);
  if (nbits == 16 && es == 2) return dequantize<16, 2, uint16_t>(p, out, n, s);
  if (nbits == 16 && es == 1) return dequantize<16, 1, uint16_t>(p, out, n, s);
  if (nbits == 8 && es == 2) return dequantize<8, 2, uint8_t>(p, out, n, s);
  if (nbits == 8 && es == 0) return dequantize<8, 0, uint8_t>(p, out, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
