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
// Bound on the H100: memory, and at the serving path's sizes (a decode
// step's 8 rows x 1 280 values per leaf) launch latency: 4 B (f32) or
// 2 B (bf16) read and 2 B (posit16) written per element.  The encode is
// ``posit.cuh``'s ``from_f32``, the same RNE as ``core/convert.py`` and
// the codec kernel, so the arena bytes equal quantize-then-scatter bit
// for bit.  A thread per element, grid-stride, the job on grid.y.
//
// Plain C interface (loaded through ctypes); returns the CUDA error code
// of the launch, 0 on success.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "posit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxJobs = 128;
constexpr int kMaxBlocksX = 1024;

struct Jobs {
  const void* src[kMaxJobs];
  void* arena[kMaxJobs];
  int width[kMaxJobs];
};

template <int N, typename P, typename S>
__global__ void __launch_bounds__(kThreads)
paged_write_kernel(const __grid_constant__ Jobs jobs, const long long* __restrict__ slots,
                   long long rows, long long n_slots) {
  const int j = blockIdx.y;
  const long long width = jobs.width[j];
  const S* __restrict__ src = static_cast<const S*>(jobs.src[j]);
  P* __restrict__ arena = static_cast<P*>(jobs.arena[j]);
  const long long n = rows * width;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / width;
    const long long slot = slots[row];
    if (slot < 0 || slot >= n_slots) continue;  // dropped write
    float x;
    if constexpr (sizeof(S) == 2) {
      x = __bfloat162float(src[i]);
    } else {
      x = src[i];
    }
    arena[slot * width + (i - row * width)] = static_cast<P>(posit::from_f32<N, 2>(x));
  }
}

template <int N, typename P, typename S>
int launch(const Jobs& jobs, int n_jobs, int max_width, const long long* slots, long long rows,
           long long n_slots, cudaStream_t s) {
  const long long blocks = (rows * max_width + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(blocks < kMaxBlocksX ? (blocks > 0 ? blocks : 1)
                                                             : kMaxBlocksX),
                  static_cast<unsigned>(n_jobs));
  paged_write_kernel<N, P, S><<<grid, kThreads, 0, s>>>(jobs, slots, rows, n_slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// nbits: 16 or 8 (es 2).  src_kind: 0 = f32, 1 = bf16.  srcs, arenas and
// widths are host arrays of n_jobs (1..128) entries; slots is a device
// pointer to rows int64 destinations (slot in [0, n_slots) or dropped).
extern "C" int posit_paged_write(int nbits, int src_kind, int n_jobs, const void* const* srcs,
                                 void* const* arenas, const int* widths, const void* slots,
                                 long long rows, long long n_slots, void* stream) {
  if (n_jobs <= 0 || rows <= 0) return 0;
  if (n_jobs > kMaxJobs || n_slots <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Jobs jobs;
  int max_width = 0;
  for (int j = 0; j < n_jobs; ++j) {
    if (widths[j] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    jobs.src[j] = srcs[j];
    jobs.arena[j] = arenas[j];
    jobs.width[j] = widths[j];
    max_width = widths[j] > max_width ? widths[j] : max_width;
  }
  const long long* sl = static_cast<const long long*>(slots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbits == 16 && src_kind == 0) return launch<16, uint16_t, float>(jobs, n_jobs, max_width, sl, rows, n_slots, s);
  if (nbits == 16 && src_kind == 1) return launch<16, uint16_t, __nv_bfloat16>(jobs, n_jobs, max_width, sl, rows, n_slots, s);
  if (nbits == 8 && src_kind == 0) return launch<8, uint8_t, float>(jobs, n_jobs, max_width, sl, rows, n_slots, s);
  if (nbits == 8 && src_kind == 1) return launch<8, uint8_t, __nv_bfloat16>(jobs, n_jobs, max_width, sl, rows, n_slots, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
