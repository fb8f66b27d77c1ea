// Row-wise posit dot product through the quire-lite: (R, L) x (R, L) -> (R,).
//
// Replaces the Pallas TPU kernel ``repro/kernels/posit_dot.py``
// ``vpdot_rows`` (``_vpdot_kernel``): per tile of MAX_DOT_LENGTH = 4096
// elements, the products are aligned to the tile's largest product
// exponent, floored and summed mod 2^128; the tile states fold in order
// (``quire_combine``) and the result rounds once.  The TPU walks the K
// tiles as a sequential grid dimension with the state in VMEM scratch;
// here one warp owns a row and a loop over the tiles takes its place,
// the state in registers.
//
// Why two passes per tile: the alignment exponent is the maximum over
// the whole tile (core/dot.py), and every product is floored against
// it, so no product can be placed before the tile's maximum is known.
// Pass 1 takes a warp-wide max of the product exponents; pass 2 places
// each product (pvu::place_add) and the warp sums the 128-bit
// contributions.  Within a tile the sum is exact mod 2^128 and the
// sticky an OR, so the lanes may add in any order; across tiles the
// fold is in order, from element 0, exactly as the reference tiles.
//
// Bound on the H100: integer operations -- per product two decodes, a
// 32x32 multiply, a 128-bit shift and add, twice (the max pass
// decodes again); the patterns themselves are few bytes.  The design
// is the simple one: warp per row, no shared memory.
//
// Plain C interface (loaded through ctypes); the entry returns the CUDA
// error code of its launch, 0 on success.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pvu.cuh"

namespace {

constexpr int kWarps = 4;            // rows per block
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ pvu::u128 warp_sum128(pvu::u128 v) {
  using ull = unsigned long long;
  ull lo = static_cast<ull>(v), hi = static_cast<ull>(v >> 64);
  for (int off = 16; off > 0; off >>= 1) {
    const ull lo2 = __shfl_xor_sync(kFull, lo, off);
    const ull hi2 = __shfl_xor_sync(kFull, hi, off);
    const ull s = lo + lo2;
    hi = hi + hi2 + (s < lo ? 1ull : 0ull);
    lo = s;
  }
  return (static_cast<pvu::u128>(hi) << 64) | lo;
}

template <int N, int ES, typename P>
__global__ void dot_kernel(const P* __restrict__ a, const P* __restrict__ b,
                           P* __restrict__ out, long long rows, long long len) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;                       // whole warps leave together
  const P* x = a + row * len;
  const P* y = b + row * len;
  pvu::Quire s = pvu::quire_empty();
  for (long long t0 = 0; t0 < len; t0 += pvu::kMaxDotLength) {
    const long long t1 = t0 + pvu::kMaxDotLength < len ? t0 + pvu::kMaxDotLength : len;
    pvu::Quire t = pvu::quire_empty();
    bool nar = false;
    for (long long i = t0 + lane; i < t1; i += 32) {
      const pvu::Pir pa = pvu::decode<N, ES>(x[i]), pb = pvu::decode<N, ES>(y[i]);
      const int e = pvu::product_exp(pa, pb);
      t.m_exp = e > t.m_exp ? e : t.m_exp;
      nar = nar || pa.nar || pb.nar;
    }
    for (int off = 16; off > 0; off >>= 1) {
      const int o = __shfl_xor_sync(kFull, t.m_exp, off);
      t.m_exp = o > t.m_exp ? o : t.m_exp;
    }
    t.nar = __any_sync(kFull, nar);
    pvu::TileSum sum = pvu::tile_sum_empty();
    for (long long i = t0 + lane; i < t1; i += 32) {
      const pvu::Pir pa = pvu::decode<N, ES>(x[i]), pb = pvu::decode<N, ES>(y[i]);
      pvu::place_add<(N <= 16)>(&sum, pvu::place_sig<(N <= 16)>(pa.sig),
                                pvu::place_sig<(N <= 16)>(pb.sig), t.m_exp - (pa.exp + pb.exp),
                                pa.sign ^ pb.sign);
    }
    t.acc = warp_sum128(sum.acc + sum.ones);
    t.sticky = __any_sync(kFull, sum.sticky != 0u) ? 1u : 0u;
    s = pvu::quire_combine(s, t);
  }
  if (lane == 0) out[row] = static_cast<P>(pvu::quire_finalize<N, ES>(s));
}

template <int N, int ES, typename P>
int launch(const void* a, const void* b, void* out, long long rows, long long len,
           cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  dot_kernel<N, ES, P><<<blocks, 32 * kWarps, 0, s>>>(
      static_cast<const P*>(a), static_cast<const P*>(b), static_cast<P*>(out), rows, len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b: (rows, len) contiguous patterns; out: (rows,).  len >= 1.
extern "C" int posit_dot_rows(int nbits, int es, const void* a, const void* b,
                              void* out, long long rows, long long len, void* stream) {
  if (rows <= 0) return 0;
  if (len <= 0 || (rows + kWarps - 1) / kWarps > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbits == 32 && es == 2) return launch<32, 2, uint32_t>(a, b, out, rows, len, s);
  if (nbits == 16 && es == 2) return launch<16, 2, uint16_t>(a, b, out, rows, len, s);
  if (nbits == 16 && es == 1) return launch<16, 1, uint16_t>(a, b, out, rows, len, s);
  if (nbits == 8 && es == 2) return launch<8, 2, uint8_t>(a, b, out, rows, len, s);
  if (nbits == 8 && es == 0) return launch<8, 0, uint8_t>(a, b, out, rows, len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
