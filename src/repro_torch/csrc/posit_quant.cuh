// The f32 -> posit encode of the two quantizers on the card: the codec's
// quantize (``posit_codec.cu``) and the fused paged KV write
// (``posit_paged_write.cu``).
//
// The arithmetic is ``posit.cuh``'s: a table entry per (sign, biased
// exponent) and one 32-bit rounding, bit-identical to
// ``core/convert.py::f32_to_posit``.  Here the table lives in shared
// memory, 512 entries of 16 bytes that each CTA fills once (a thread an
// exponent writes its two signs' entries) before its first encode, and
// an element costs one ``LDS.128`` at ``bits >> 23`` and some eight
// integer instructions.  A ``__constant__`` table would serialise: the
// lanes of a warp read different entries.
//
// Sources are f32 (one 32-bit word an element) or bf16 (a 16-bit half
// word, whose bits are the top of the f32's); both are read as raw words,
// so a bf16 element costs one shift or mask to become f32 bits.  Outputs
// go out as 16-byte vectors of 4 posit32, 8 posit16 or 16 posit8.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "posit.cuh"

namespace quant {

constexpr int kLutEntries = 512;

// each thread of the CTA writes the entries of its exponents (all 256 in
// one pass at 256 threads); the caller syncs before the first encode
template <int N, int ES>
__device__ __forceinline__ void fill_lut(posit::F32Entry* lut) {
  for (uint32_t e = threadIdx.x; e < 256u; e += blockDim.x) posit::f32_fill<N, ES>(lut, e);
}

// the pattern of the f32 ``bits`` (its low N bits)
template <int N, int ES>
__device__ __forceinline__ uint32_t encode(const posit::F32Entry* lut, uint32_t bits) {
  return posit::f32_round<N>(lut[bits >> 23], bits);
}

// the f32 bits of source element k among a vector's words
template <typename S>
__device__ __forceinline__ uint32_t f32_bits_at(const uint32_t* w, int k) {
  if constexpr (sizeof(S) == 4) {
    return w[k];
  } else {
    return (k & 1) ? (w[k >> 1] & 0xFFFF0000u) : (w[k >> 1] << 16);
  }
}

// the f32 bits of one source element in memory
template <typename S>
__device__ __forceinline__ uint32_t f32_bits_of(const S* p) {
  return sizeof(S) == 4 ? static_cast<uint32_t>(__ldg(p))
                        : static_cast<uint32_t>(__ldg(p)) << 16;
}

// kE source elements as 32-bit words: 16-byte loads where ``aligned``,
// else one element at a time (a view at an odd offset)
template <typename S, int kE>
__device__ __forceinline__ void load_src(const S* p, bool aligned,
                                         uint32_t (&w)[kE * sizeof(S) / 4]) {
  constexpr int kWords = kE * static_cast<int>(sizeof(S)) / 4;
  if (aligned) {
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
#pragma unroll
    for (int k = 0; k < kE; ++k)
      w[k * sizeof(S) / 4] |= static_cast<uint32_t>(__ldg(p + k))
                              << (8 * sizeof(S) * (k % (4 / sizeof(S))));
  }
}

// the 16-byte vector of patterns P of the 16 / sizeof(P) source elements
// in ``w``
template <int N, int ES, typename P, typename S>
__device__ __forceinline__ uint4 encode_vec(const posit::F32Entry* lut, const uint32_t* w) {
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    constexpr int kPer = 4 / static_cast<int>(sizeof(P));  // patterns a word
    uint32_t p[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) p[k] = encode<N, ES>(lut, f32_bits_at<S>(w, j * kPer + k));
    if constexpr (kPer == 1) {
      o[j] = p[0];
    } else if constexpr (kPer == 2) {
      o[j] = __byte_perm(p[0], p[1], 0x5410);
    } else {
      o[j] = __byte_perm(__byte_perm(p[0], p[1], 0x0040), __byte_perm(p[2], p[3], 0x0040),
                         0x5410);
    }
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

}  // namespace quant
