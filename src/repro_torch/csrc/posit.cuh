// Posit <-> float32 codec for one element, on native 32/64-bit integers.
//
// The per-element arithmetic of the port's codec and paged-attention
// kernels: the same decode (regime LZC, exponent, fraction) and the same
// round-to-nearest-even encode as ``repro_torch/core/{pir,convert}.py``,
// which emulate 64-bit lanes with pairs of 32-bit ones.  Here the encode
// stream is one ``uint64_t`` and the LZC is ``__clz``.  Results must be
// bit-identical to the Python codec for every input.
//
// Shifts follow ``core/bits.py``: ``sll``/``srl`` return 0 for any amount
// outside [0, width), which C++ leaves undefined, so every variable shift
// goes through them.
//
// Header-only and free of CUDA types, so a host compiler can build it
// for exhaustive checks against the Python codec.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define POSIT_HD __host__ __device__ __forceinline__
#else
#define POSIT_HD inline
#endif

namespace posit {

POSIT_HD int clz32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __clz(static_cast<int>(x));
#else
  return x ? __builtin_clz(x) : 32;
#endif
}

POSIT_HD uint32_t sll32(uint32_t x, int s) { return (s >= 0 && s < 32) ? (x << s) : 0u; }
POSIT_HD uint32_t srl32(uint32_t x, int s) { return (s >= 0 && s < 32) ? (x >> s) : 0u; }
POSIT_HD uint64_t sll64(uint64_t x, int s) { return (s >= 0 && s < 64) ? (x << s) : 0ull; }
POSIT_HD uint64_t srl64(uint64_t x, int s) { return (s >= 0 && s < 64) ? (x >> s) : 0ull; }
POSIT_HD int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

POSIT_HD uint32_t f32_bits(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  union { float f; uint32_t u; } c;
  c.f = f;
  return c.u;
#endif
}

POSIT_HD float bits_f32(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  union { float f; uint32_t u; } c;
  c.u = u;
  return c.f;
#endif
}

// Posit pattern -> f32 (core/pir.py::decode + core/convert.py::posit_to_f32).
template <int N, int ES>
POSIT_HD float to_f32(uint32_t p) {
  const uint32_t mask = N < 32 ? ((1u << N) - 1u) : 0xFFFFFFFFu;
  const uint32_t x = p & mask;
  const bool is_zero = x == 0u;
  const bool is_nar = x == (1u << (N - 1));
  if (is_nar) return bits_f32(0x7FC00000u);
  if (is_zero) return 0.0f;

  const uint32_t sign = (x >> (N - 1)) & 1u;
  const uint32_t ax = sign ? ((~x + 1u) & mask) : x;
  const uint32_t y = ax << (32 - N);                 // sign at bit 31
  const uint32_t r0 = (y >> 30) & 1u;
  const uint32_t t = ((r0 ? ~y : y) & 0x7FFFFFFFu) << 1;
  const int run = clz32(t);
  const int k = run < N - 1 ? run : N - 1;           // regime run length
  const int r = r0 ? k - 1 : -k;
  const uint32_t body = sll32(y, k + 2);
  const uint32_t e = ES > 0 ? (body >> (32 - ES)) : 0u;
  const uint32_t sig = 0x80000000u | (sll32(body, ES) >> 1);
  const int exp = r * (1 << ES) + static_cast<int>(e);

  // mantissa field = sig >> rs rounded at bit rs-1; rs > 8 for f32
  // subnormals so the hidden bit lands inside the field
  const bool is_sub = exp < -126;
  const int rs = is_sub ? clampi(-(exp + 118), 9, 40) : 8;
  const uint32_t pre = srl32(sig, rs);
  const uint32_t round_bit = srl32(sig, rs - 1) & 1u;
  const uint32_t below = sll32(1u, rs - 1) - 1u;     // wraps to all ones
  const uint32_t sticky = (sig & below) != 0u;
  const uint32_t man = pre & 0x7FFFFFu;
  const uint32_t man_r = man + (round_bit & (sticky | (man & 1u)));
  const int carry = static_cast<int>(man_r >> 23);
  int biased = (is_sub ? -127 : exp) + carry + 127;
  if (biased > 254) return bits_f32((sign << 31) | 0x7F800000u);
  biased = clampi(biased, 0, 254);
  return bits_f32((sign << 31) | (static_cast<uint32_t>(biased) << 23) |
                  (man_r & 0x7FFFFFu));
}

// PIR -> posit pattern with round-to-nearest-even (core/pir.py::encode).
template <int N, int ES>
POSIT_HD uint32_t encode(uint32_t sign, int exp, uint32_t sig, uint32_t sticky) {
  const uint32_t mask = N < 32 ? ((1u << N) - 1u) : 0xFFFFFFFFu;
  const uint32_t maxpos = (1u << (N - 1)) - 1u;
  const int max_scale = (N - 2) * (1 << ES);
  const bool too_big = exp > max_scale;
  const bool too_small = exp < -max_scale;
  const int expc = clampi(exp, -max_scale, max_scale);
  // floor division by 2^es without shifting a negative value
  const int r = expc >= 0 ? (expc >> ES) : -((-expc + (1 << ES) - 1) >> ES);
  const int e = expc - r * (1 << ES);

  const int reg_len = r >= 0 ? r + 2 : 1 - r;
  uint32_t v_reg = 1u;
  if (r >= 0) v_reg = (r + 2 >= 32) ? 0xFFFFFFFEu : (sll32(2u, r + 1) - 2u);

  uint64_t stream = sll64(v_reg, 64 - reg_len);
  if (ES > 0) stream |= sll64(static_cast<uint32_t>(e), 64 - reg_len - ES);
  const uint32_t frac31 = sig & 0x7FFFFFFFu;
  const int fsh = 33 - reg_len - ES;                 // fraction LSB position
  stream |= fsh >= 0 ? sll64(frac31, fsh) : srl64(frac31, -fsh);
  if (fsh < 0 && (frac31 & (sll32(1u, -fsh) - 1u)) != 0u) sticky = 1u;
  stream |= sticky;

  const uint32_t body = static_cast<uint32_t>(srl64(stream, 64 - (N - 1)));
  const uint32_t round_bit = static_cast<uint32_t>(srl64(stream, 64 - N) & 1ull);
  const uint32_t sticky_rest = (stream & (sll64(1ull, 64 - N) - 1ull)) != 0ull;
  uint32_t p = body + (round_bit & (sticky_rest | (body & 1u)));
  p = p > maxpos ? maxpos : p;                       // never past maxpos
  p = p < 1u ? 1u : p;                               // never to zero
  if (too_big) p = maxpos;
  if (too_small) p = 1u;
  if (sign) p = (~p + 1u) & mask;
  return p;
}

// f32 -> posit pattern (core/convert.py::f32_to_posit).
template <int N, int ES>
POSIT_HD uint32_t from_f32(float f) {
  const uint32_t bits = f32_bits(f);
  const uint32_t sign = bits >> 31;
  const uint32_t exp8 = (bits >> 23) & 0xFFu;
  const uint32_t man = bits & 0x7FFFFFu;
  if (exp8 == 255u) return 1u << (N - 1);            // inf / nan -> NaR
  if (exp8 == 0u && man == 0u) return 0u;
  if (exp8 == 0u) {                                  // subnormal
    const int sh = clz32(man);
    return encode<N, ES>(sign, -118 - sh, sll32(man, sh), 0u);
  }
  return encode<N, ES>(sign, static_cast<int>(exp8) - 127,
                       0x80000000u | (man << 8), 0u);
}

}  // namespace posit
