// Fused elementwise PVU ops on posit patterns: vadd, vsub, vmul, vdiv.
//
// Replaces the Pallas TPU kernel ``repro/kernels/posit_ew.py``
// ``elementwise_2d`` (``_ew_kernel``): decode both operands to PIR, run
// the add/sub/mul/div datapath, encode once with the sticky bit -- no
// f32 round trip.  The arithmetic is ``pvu.cuh``, bit-identical to
// ``repro_torch/core/arith.py``.
//
// Design: one thread per element in a grid-stride loop over a flat
// buffer, templated on (nbits, es), the op and the divider.  An operand
// with fewer elements than the output (a scalar, or a bias row against
// (rows, cols)) is read at ``i % n_operand``: the wrapper passes only
// operands whose shape is a suffix of the output's, so nothing is
// broadcast into device memory.
//
// Bound on the H100: bytes for add, sub and mul (3 patterns moved per
// element, a few dozen integer ops on them); the dividers carry three
// 64-bit Newton-Raphson steps (nr3) or 33 restoring steps (exact) per
// element, which may make them bound by integer operations instead.
// The design keeps one coalesced pass with no shared memory.
//
// Plain C interface (loaded through ctypes); the entry returns the CUDA
// error code of its launch, 0 on success.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pvu.cuh"

namespace {

constexpr int kThreads = 256;

template <int N, int ES, int OP, typename P>
__global__ void ew_kernel(const P* __restrict__ a, const P* __restrict__ b,
                          P* __restrict__ out, long long n, long long na,
                          long long nb) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const uint32_t pa = a[na == n ? i : (na == 1 ? 0 : i % na)];
    const uint32_t pb = b[nb == n ? i : (nb == 1 ? 0 : i % nb)];
    out[i] = static_cast<P>(pvu::elementwise<N, ES, OP>(pa, pb));
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // enough waves to fill 132 SMs
  return static_cast<int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

template <int N, int ES, typename P>
int launch(int op, const void* a, const void* b, void* out, long long n,
           long long na, long long nb, cudaStream_t s) {
  const P* pa = static_cast<const P*>(a);
  const P* pb = static_cast<const P*>(b);
  P* po = static_cast<P*>(out);
  const int g = grid_for(n);
  switch (op) {
    case pvu::kAdd: ew_kernel<N, ES, pvu::kAdd, P><<<g, kThreads, 0, s>>>(pa, pb, po, n, na, nb); break;
    case pvu::kSub: ew_kernel<N, ES, pvu::kSub, P><<<g, kThreads, 0, s>>>(pa, pb, po, n, na, nb); break;
    case pvu::kMul: ew_kernel<N, ES, pvu::kMul, P><<<g, kThreads, 0, s>>>(pa, pb, po, n, na, nb); break;
    case pvu::kDivNr3: ew_kernel<N, ES, pvu::kDivNr3, P><<<g, kThreads, 0, s>>>(pa, pb, po, n, na, nb); break;
    case pvu::kDivExact: ew_kernel<N, ES, pvu::kDivExact, P><<<g, kThreads, 0, s>>>(pa, pb, po, n, na, nb); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// op: 0 add, 1 sub, 2 mul, 3 div nr3, 4 div exact.  na and nb are the
// operands' element counts: n, 1, or a divisor of n (suffix broadcast).
extern "C" int posit_elementwise(int nbits, int es, int op, const void* a,
                                 const void* b, void* out, long long n,
                                 long long na, long long nb, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbits == 32 && es == 2) return launch<32, 2, uint32_t>(op, a, b, out, n, na, nb, s);
  if (nbits == 16 && es == 2) return launch<16, 2, uint16_t>(op, a, b, out, n, na, nb, s);
  if (nbits == 16 && es == 1) return launch<16, 1, uint16_t>(op, a, b, out, n, na, nb, s);
  if (nbits == 8 && es == 2) return launch<8, 2, uint8_t>(op, a, b, out, n, na, nb, s);
  if (nbits == 8 && es == 0) return launch<8, 0, uint8_t>(op, a, b, out, n, na, nb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
