// Posit quantize fused into the paged KV write: f32 (or bf16) KV rows go
// straight into their arena slots as posit patterns.
//
// Replaces, on the serving path, the Pallas TPU kernel
// ``repro/kernels/posit_codec.py`` ``quantize_2d`` (``_quant_kernel``)
// followed by the cache write, the composite the reference computes at
// every KV write (``repro/models/transformer.py`` ``_maybe_quant_kv``,
// then ``paged_cache_update`` / ``paged_pack_range``).  One launch takes
// a list of jobs, each an arena leaf of one layer (nb * bs slots of
// ``width`` patterns) and its (rows, width) source; every job shares the
// rows' destinations ``slots`` (rows,) int64: a flat slot index
// block * bs + offset, or a negative drop marker.  Masked rows (inactive,
// past the table, an older ring epoch) and writes through sentinel
// table entries arrive as drops and are skipped on the device, so the
// caller needs no host sync to compact them.  Decode writes both leaves
// of a layer in one launch; a prefill chunk writes one leaf of every
// layer in one launch.
//
// Bound on the H100: memory, 2 B (bf16) or 4 B (f32) read and 2 B
// (posit16) or 1 B (posit8) written per element; at a decode step's 2 x
// 8 rows of 1 280, launch latency.  The encode is ``posit_quant.cuh``'s
// (a shared-memory table entry per sign and exponent, one 32-bit
// rounding), the same patterns as ``core/convert.py`` and the codec
// kernel, so the arena bytes equal quantize-then-scatter bit for bit.
// The design:
// - a group of lanes a (job, row): the job on grid.y, 1, 2, 4 or 8 rows
//   a CTA on grid.x, chosen by the launch's size.  A large launch (a
//   prefill leaf: 40 layers x 128 rows) takes 8 rows a CTA, a warp a row,
//   so that few CTAs fill a table; a small one (a decode step's 2 x 8
//   rows) takes a CTA a row, so that a lane encodes one vector and the
//   launch's latency is one slot read, one source read and one store.
//   The group reads its row's slot once; a dropped row (negative, at or
//   past ``n_slots``) reads no source.  No division per element.
// - 16-byte vectors: a lane issues up to four 16-byte source loads a trip
//   (4 vectors of 8 bf16 for posit16, 2 of f32; 2 and 1 vectors of 16
//   for posit8) before it encodes any, and stores 16-byte vectors of
//   patterns; the first trip's loads fly while the CTA fills its table.
//   A row's ragged head (to its slot's first 16-byte boundary) and tail
//   are scalar; a source row not 16-byte aligned where the slot's vectors
//   start is read an element at a time.  The main path's widths (1 280;
//   MLA 256 and 32) are whole vectors.
// - the job table is a ``__grid_constant__`` parameter sized for 2 jobs
//   (a decode step's K and V, 40 bytes) or for 128 (a prefill leaf of
//   every layer, 2 560 bytes): the decode launch carries no unused table.
//
// Plain C interface (loaded through ctypes); returns the CUDA error code
// of the launch, 0 on success.
#include <cuda_runtime.h>
#include <stdint.h>

#include "posit.cuh"
#include "posit_quant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowsPerCta = kThreads / 32;  // a warp a row
constexpr int kMinCtas = 256;                   // ~2 an SM: fewer rows a CTA below it
constexpr int kMaxJobs = 128;

template <int kCap>
struct Jobs {
  const void* src[kCap];
  void* arena[kCap];
  int width[kCap];
};

// S: the source's raw element (uint32_t for f32, uint16_t for bf16)
template <int N, typename P, typename S, int kCap>
__global__ void __launch_bounds__(kThreads)
paged_write_kernel(const __grid_constant__ Jobs<kCap> jobs, const long long* __restrict__ slots,
                   long long rows, long long n_slots, int rows_per_cta) {
  constexpr int kV = 16 / static_cast<int>(sizeof(P));           // patterns a vector
  constexpr int kW = kV * static_cast<int>(sizeof(S)) / 4;       // source words a vector
  constexpr int kU = 4 * static_cast<int>(sizeof(P)) / static_cast<int>(sizeof(S));  // a trip
  static_assert(kU >= 1 && kU * kW == 16, "four 16-byte source loads a trip");
  __shared__ posit::F32Entry lut[quant::kLutEntries];
  const int group = kThreads / rows_per_cta;                     // lanes a row
  const int lane = threadIdx.x % group;
  const int j = blockIdx.y;
  const long long row = static_cast<long long>(blockIdx.x) * rows_per_cta + threadIdx.x / group;
  const int width = jobs.width[j];
  const long long slot = row < rows ? __ldg(slots + row) : -1;
  const bool live = slot >= 0 && slot < n_slots;                 // uniform in the group
  const S* src = static_cast<const S*>(jobs.src[j]) + (live ? row * width : 0);
  P* dst = static_cast<P*>(jobs.arena[j]) + (live ? slot * width : 0);
  // the row as 16-byte output vectors after a ragged head, then a tail
  int head = static_cast<int>((16 - reinterpret_cast<uintptr_t>(dst) % 16) % 16 / sizeof(P));
  head = head < width ? head : width;
  const int nvec = live ? (width - head) / kV : 0;
  const bool svec = reinterpret_cast<uintptr_t>(src + head) % 16 == 0;
  uint32_t w[kU][kW];
  auto load = [&](int v0) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int v = v0 + u * group + lane;
      if (v < nvec) quant::load_src<S, kV>(src + head + v * kV, svec, w[u]);
    }
  };
  auto store = [&](int v0) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int v = v0 + u * group + lane;
      if (v < nvec)
        *reinterpret_cast<uint4*>(dst + head + v * kV) = quant::encode_vec<N, 2, P, S>(lut, w[u]);
    }
  };

  load(0);                                // in flight while the table fills
  quant::fill_lut<N, 2>(lut);
  __syncthreads();
  if (!live) return;                      // dropped write
  const int tail_at = head + nvec * kV;
  for (int i = lane; i < head + (width - tail_at); i += group) {
    const int k = i < head ? i : tail_at + (i - head);
    dst[k] = static_cast<P>(quant::encode<N, 2>(lut, quant::f32_bits_of(src + k)));
  }
  for (int v0 = 0;;) {
    store(v0);
    v0 += group * kU;
    if (v0 >= nvec) break;
    load(v0);
  }
}

// an empty kernel with the same parameters and grid: the launch floor
template <int kCap>
__global__ void __launch_bounds__(kThreads)
paged_write_floor_kernel(const __grid_constant__ Jobs<kCap> jobs, const long long* slots,
                         long long rows, long long n_slots, int rows_per_cta) {}

template <int N, typename P, typename S, int kCap>
int launch(bool floor, int n_jobs, const void* const* srcs, void* const* arenas,
           const int* widths, const long long* slots, long long rows, long long n_slots,
           cudaStream_t s) {
  Jobs<kCap> jobs;
  for (int j = 0; j < n_jobs; ++j) {
    jobs.src[j] = srcs[j];
    jobs.arena[j] = arenas[j];
    jobs.width[j] = widths[j];
  }
  // the most rows a CTA that still gives kMinCtas CTAs (or one row)
  int r = kMaxRowsPerCta;
  while (r > 1 && (rows + r - 1) / r * n_jobs < kMinCtas) r /= 2;
  const dim3 grid(static_cast<unsigned>((rows + r - 1) / r), static_cast<unsigned>(n_jobs));
  if (floor) {
    paged_write_floor_kernel<kCap><<<grid, kThreads, 0, s>>>(jobs, slots, rows, n_slots, r);
  } else {
    paged_write_kernel<N, P, S, kCap><<<grid, kThreads, 0, s>>>(jobs, slots, rows, n_slots, r);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int N, typename P, typename S>
int launch_cap(bool floor, int n_jobs, const void* const* srcs, void* const* arenas,
               const int* widths, const long long* slots, long long rows, long long n_slots,
               cudaStream_t s) {
  if (n_jobs <= 2)
    return launch<N, P, S, 2>(floor, n_jobs, srcs, arenas, widths, slots, rows, n_slots, s);
  return launch<N, P, S, kMaxJobs>(floor, n_jobs, srcs, arenas, widths, slots, rows, n_slots,
                                   s);
}

int run(bool floor, int nbits, int src_kind, int n_jobs, const void* const* srcs,
        void* const* arenas, const int* widths, const void* slots, long long rows,
        long long n_slots, void* stream) {
  if (n_jobs <= 0 || rows <= 0) return 0;
  if (n_jobs > kMaxJobs || n_slots <= 0 || rows > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = nbits / 8, src_elem = src_kind == 0 ? 4 : 2;
  for (int j = 0; j < n_jobs; ++j) {
    if (widths[j] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if (reinterpret_cast<uintptr_t>(arenas[j]) % elem != 0 ||
        reinterpret_cast<uintptr_t>(srcs[j]) % src_elem != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const long long* sl = static_cast<const long long*>(slots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_WRITE(N, P, S) \
  return launch_cap<N, P, S>(floor, n_jobs, srcs, arenas, widths, sl, rows, n_slots, s)
  if (nbits == 16 && src_kind == 0) PAGED_WRITE(16, uint16_t, uint32_t);
  if (nbits == 16 && src_kind == 1) PAGED_WRITE(16, uint16_t, uint16_t);
  if (nbits == 8 && src_kind == 0) PAGED_WRITE(8, uint8_t, uint32_t);
  if (nbits == 8 && src_kind == 1) PAGED_WRITE(8, uint8_t, uint16_t);
#undef PAGED_WRITE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// nbits: 16 or 8 (es 2).  src_kind: 0 = f32, 1 = bf16.  srcs, arenas and
// widths are host arrays of n_jobs (1..128) entries; slots is a device
// pointer to rows int64 destinations (slot in [0, n_slots) or dropped).
extern "C" int posit_paged_write(int nbits, int src_kind, int n_jobs, const void* const* srcs,
                                 void* const* arenas, const int* widths, const void* slots,
                                 long long rows, long long n_slots, void* stream) {
  return run(false, nbits, src_kind, n_jobs, srcs, arenas, widths, slots, rows, n_slots,
             stream);
}

// The same call launching an empty kernel with the same job table and
// grid: the launch floor under ``posit_paged_write`` (for timing).
extern "C" int posit_paged_write_floor(int nbits, int src_kind, int n_jobs,
                                       const void* const* srcs, void* const* arenas,
                                       const int* widths, const void* slots, long long rows,
                                       long long n_slots, void* stream) {
  return run(true, nbits, src_kind, n_jobs, srcs, arenas, widths, slots, rows, n_slots,
             stream);
}
