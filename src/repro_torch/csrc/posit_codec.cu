// Posit codec kernels: f32 -> posit patterns (quantize) and back.
//
// Replaces the Pallas TPU kernels ``repro/kernels/posit_codec.py``
// ``quantize_2d`` / ``dequantize_2d`` (``_quant_kernel`` /
// ``_dequant_kernel``).  Elementwise over a flat buffer: one thread per
// element, grid-stride, templated on (nbits, es) for the five configs of
// ``core/types.py`` (posit32, posit16, posit8 with es = 2; posit16 es 1;
// posit8 es 0).  The arithmetic is ``posit.cuh`` -- the same decode, RNE
// encode and saturation as ``core/convert.py``, on native 32/64-bit
// integers (``__clz``, one ``uint64_t`` encode stream).
//
// Bound on the H100: memory.  Quantize reads 4 B and writes 2 B (posit16)
// per element; the integer work is a few dozen ALU ops per element, far
// below the card's integer rate.  The design keeps the kernel a single
// pass with coalesced loads and stores and no shared memory.
//
// Plain C interface (loaded through ctypes); each entry returns the CUDA
// error code of its launch, 0 on success.
#include <cuda_runtime.h>
#include <stdint.h>

#include "posit.cuh"

namespace {

constexpr int kThreads = 256;

template <int N, int ES, typename P>
__global__ void quantize_kernel(const float* __restrict__ x, P* __restrict__ out,
                                long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = static_cast<P>(posit::from_f32<N, ES>(x[i]));
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
int quantize(const void* x, void* out, long long n, cudaStream_t s) {
  quantize_kernel<N, ES, P><<<grid_for(n), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<P*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int ES, typename P>
int dequantize(const void* p, void* out, long long n, cudaStream_t s) {
  dequantize_kernel<N, ES, P><<<grid_for(n), kThreads, 0, s>>>(
      static_cast<const P*>(p), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int posit_quantize(int nbits, int es, const void* x, void* out, long long n,
                              void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbits == 32 && es == 2) return quantize<32, 2, uint32_t>(x, out, n, s);
  if (nbits == 16 && es == 2) return quantize<16, 2, uint16_t>(x, out, n, s);
  if (nbits == 16 && es == 1) return quantize<16, 1, uint16_t>(x, out, n, s);
  if (nbits == 8 && es == 2) return quantize<8, 2, uint8_t>(x, out, n, s);
  if (nbits == 8 && es == 0) return quantize<8, 0, uint8_t>(x, out, n, s);
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
