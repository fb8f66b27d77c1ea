"""A stand-in for the CUDA runtime under which ``csrc/*.cu`` kernels
compile with ``g++`` and run on the host.

A launch runs each CTA in turn (grid.x fastest, then grid.y) as
``blockDim.x`` ``std::thread``s; ``__syncthreads`` is a barrier of the
CTA's threads; a warp shuffle goes through an exchange array between two
barriers of the warp's threads; dynamic shared memory is one buffer
(filled with a junk pattern before every CTA) and static ``__shared__``
arrays are function statics (one CTA runs at a time); ``__ldg`` is a
plain load, ``__byte_perm`` a byte select.  A 16-byte load or store
(``uint4``) at an address that is not a multiple of 16, which faults on
the card, makes the launch return ``cudaErrorMisalignedAddress``.  The sources copy with
``memcpy`` where the card runs ``cp.async``.  The kernels' C entry
points then take CPU tensors' addresses.  Keep shapes small: a thread
per CUDA thread.

Shared by the host runs of the kernels (``test_torch_ew_dot_host.py``,
``test_torch_quantize_host.py``); not a test module.
"""
import ctypes
import re
import subprocess
from pathlib import Path

STUB = r"""
#pragma once
#include <atomic>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
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
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorMisalignedAddress = 716 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

namespace emu {
inline cudaError_t last_error = cudaSuccess;
inline std::barrier<>* cta_bar = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
inline uint32_t xchg[1024];
alignas(16) inline unsigned char smem[1 << 17];

inline uint32_t shfl_xor(uint32_t v, int off) {
  const unsigned t = threadIdx.x;
  xchg[t] = v;
  warp_bars[t / 32]->arrive_and_wait();
  const uint32_t r = xchg[(t & ~31u) | ((t & 31u) ^ static_cast<unsigned>(off))];
  warp_bars[t / 32]->arrive_and_wait();
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
  std::barrier<> bar(block.x);
  cta_bar = &bar;
  warp_bars.clear();
  for (unsigned w = 0; w < block.x / 32; ++w) warp_bars.push_back(std::make_unique<std::barrier<>>(32));
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      memset(smem, 0xA5, sizeof(smem));
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < block.x; ++t)
        ts.emplace_back([&, t, bx, by] { threadIdx = {t, 0, 0}; blockIdx = {bx, by, 0}; fn(); });
      for (auto& th : ts) th.join();
    }
  last_error = misaligned ? cudaErrorMisalignedAddress : cudaSuccess;
}
}  // namespace emu

inline void __syncthreads() { emu::cta_bar->arrive_and_wait(); }
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
