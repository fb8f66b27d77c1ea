"""A stand-in for the CUDA runtime under which ``csrc/*.cu`` kernels
compile with ``g++`` and run on the host.

A launch runs each CTA in turn (grid.x fastest, then grid.y) as
``blockDim.x`` fibers (``ucontext``) on the calling thread, each with its
own stack: a fiber runs until it blocks at a barrier, then the next one
that can run does, in thread order.  ``__syncthreads`` is a barrier of
the CTA's fibers; a warp shuffle goes through an exchange array between
two barriers of the warp's fibers; a barrier that can never complete
(a fiber that returned while others wait) ends the launch with
``cudaErrorLaunchFailure``, where the card would hang.  Dynamic shared
memory is one buffer (filled with a junk pattern before every CTA) and
static ``__shared__`` arrays are function statics (one CTA runs at a
time); ``__ldg`` is a plain load, ``__byte_perm`` a byte select.  A
16-byte load or store (``uint4``) at an address that is not a multiple
of 16, which faults on the card, makes the launch return
``cudaErrorMisalignedAddress``.  The sources copy with ``memcpy`` where
the card runs ``cp.async``.  The kernels' C entry points then take CPU
tensors' addresses.  The order in which fibers run between barriers is
one of those the card may take; a race that only another order shows
is out of its reach.  Keep shapes small: a fiber per CUDA thread.

Shared by the host runs of the kernels (``test_torch_ew_dot_host.py``,
``test_torch_quantize_host.py``, ``test_torch_dequantize_host.py``); not
a test module.
"""
import ctypes
import re
import subprocess
from pathlib import Path

STUB = r"""
#pragma once
#include <ucontext.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __grid_constant__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
namespace emu {
// a 16-byte access at an address the card would fault on
inline std::atomic<bool> misaligned{false};
inline void check16(const void* p) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) misaligned = true;
}
}  // namespace emu
struct alignas(16) uint4 {
  unsigned int x, y, z, w;
  uint4& operator=(const uint4& o) {  // a 16-byte store
    emu::check16(this);
    x = o.x, y = o.y, z = o.z, w = o.w;
    return *this;
  }
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorMisalignedAddress = 716,
  cudaErrorLaunchFailure = 719
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

// the running fiber's coordinates, set before it resumes
inline dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

namespace emu {
inline cudaError_t last_error = cudaSuccess;
struct Fiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  bool done = false;
};
constexpr size_t kStack = 1 << 18;
inline ucontext_t sched;
inline std::vector<Fiber> fibers;
inline unsigned cur = 0;
inline std::function<void()> body;
inline unsigned long long progress = 0;  // arrivals, releases and fibers finished
inline unsigned cta_count = 0, cta_gen = 0;
inline unsigned warp_count[32], warp_gen[32];
inline uint32_t xchg[1024];
alignas(16) inline unsigned char smem[1 << 17];

// a barrier of n fibers: the last to arrive moves the generation on and
// runs on; the others yield until it has moved
inline void barrier(unsigned& count, unsigned& gen, unsigned n) {
  const unsigned g = gen;
  ++progress;
  if (++count == n) {
    count = 0;
    ++gen;
    return;
  }
  while (gen == g) swapcontext(&fibers[cur].ctx, &sched);
}

inline void run_body() {
  body();
  fibers[cur].done = true;
  ++progress;
}

inline uint32_t shfl_xor(uint32_t v, int off) {
  const unsigned t = threadIdx.x, w = t / 32;
  xchg[t] = v;
  barrier(warp_count[w], warp_gen[w], 32);
  const uint32_t r = xchg[(t & ~31u) | ((t & 31u) ^ static_cast<unsigned>(off))];
  barrier(warp_count[w], warp_gen[w], 32);
  return r;
}

template <class F>
void launch(dim3 grid, dim3 block, size_t smem_bytes, cudaStream_t, F fn) {
  if (smem_bytes > sizeof(smem) || block.x % 32 != 0 || block.x > 1024 || block.y != 1 ||
      grid.x == 0 || grid.y == 0 || grid.z != 1) {
    last_error = cudaErrorInvalidValue;
    return;
  }
  gridDim = grid;
  blockDim = block;
  misaligned = false;
  body = fn;
  if (fibers.size() < block.x) fibers.resize(block.x);
  for (unsigned t = 0; t < block.x; ++t)
    if (!fibers[t].stack) fibers[t].stack.reset(new char[kStack]);
  bool hung = false;
  for (unsigned by = 0; by < grid.y && !hung; ++by)
    for (unsigned bx = 0; bx < grid.x && !hung; ++bx) {
      memset(smem, 0xA5, sizeof(smem));
      cta_count = 0;
      for (unsigned w = 0; w < 32; ++w) warp_count[w] = 0;
      for (unsigned t = 0; t < block.x; ++t) {
        Fiber& f = fibers[t];
        getcontext(&f.ctx);
        f.ctx.uc_stack.ss_sp = f.stack.get();
        f.ctx.uc_stack.ss_size = kStack;
        f.ctx.uc_link = &sched;
        makecontext(&f.ctx, run_body, 0);
        f.done = false;
      }
      for (unsigned left = block.x; left > 0;) {
        const unsigned long long before = progress;
        for (unsigned t = 0; t < block.x; ++t) {
          if (fibers[t].done) continue;
          cur = t;
          threadIdx = {t, 0, 0};
          blockIdx = {bx, by, 0};
          swapcontext(&sched, &fibers[t].ctx);
          if (fibers[t].done) --left;
        }
        if (left > 0 && progress == before) {  // every fiber waits on a barrier that cannot complete
          hung = true;
          break;
        }
      }
    }
  last_error = hung ? cudaErrorLaunchFailure
                    : misaligned ? cudaErrorMisalignedAddress : cudaSuccess;
}
}  // namespace emu

inline void __syncthreads() { emu::barrier(emu::cta_count, emu::cta_gen, blockDim.x); }
template <class T> inline T __ldg(const T* p) { return *p; }
inline uint4 __ldg(const uint4* p) {  // a 16-byte load
  emu::check16(p);
  return *p;
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int off) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  uint32_t u;
  memcpy(&u, &v, 4);
  u = emu::shfl_xor(u, off);
  T r;
  memcpy(&r, &u, 4);
  return r;
}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (static_cast<uint64_t>(y) << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i) r |= static_cast<unsigned>((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}
inline cudaError_t cudaGetLastError() { return emu::last_error; }
template <class F> inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
"""


def for_host(src: str) -> str:
    """A ``.cu`` source as C++ for the stub: the dynamic shared array is
    the stub's buffer, each ``<<<...>>>`` launch a call of
    ``emu::launch``."""
    src = re.sub(r"extern __shared__ [^;]*\b(\w+)\[\];",
                 r"unsigned char* \1 = emu::smem;", src)
    src, n = re.subn(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);",
                     r"emu::launch(\2, [&] { \1(\3); });", src, flags=re.S)
    assert n >= 1, "no <<<...>>> launch found"
    return src


def build(gxx: str, d: Path, csrc: Path, name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` compiled for the stub into ``d`` and loaded;
    ``d`` holds the stub as ``cuda_runtime.h``."""
    (d / f"{name}.cpp").write_text(for_host((csrc / f"{name}.cu").read_text()))
    so = d / f"{name}.so"
    res = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
                          "-I", str(d), "-I", str(csrc), "-o", str(so), str(d / f"{name}.cpp")],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    return ctypes.CDLL(str(so))
