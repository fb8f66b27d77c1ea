// Posit <-> float32 codec for one element, on native 32/64-bit integers.
//
// The per-element arithmetic of the port's codec and paged-attention
// kernels: the same decode (regime LZC, exponent, fraction) and the same
// round-to-nearest-even encode as ``repro_torch/core/{pir,convert}.py``,
// which emulate 64-bit lanes with pairs of 32-bit ones.  Here the LZC is
// ``__clz``, and the f32 encode is a table entry per sign and exponent
// and one 32-bit rounding.  Results must be bit-identical to the Python
// codec for every input.
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

// f32 -> posit pattern (core/convert.py::f32_to_posit), the encode of
// the two quantizers (posit_codec.cu, posit_paged_write.cu).
//
// Everything but the rounding of the mantissa depends only on the f32's
// sign and biased exponent: the regime and exponent fields, how many
// mantissa bits fit beside them, the saturation to maxpos or minpos, NaR,
// zero and subnormals (every f32 subnormal lies below minpos in all five
// configs).  So the encode is a table entry per (sign, biased exponent),
// 512 of them indexed by ``bits >> 23``, and one rounding per element
// (``f32_round``).  Writing the f32 as the bit stream
//
//   stream = fields * 2^W + m       (m the mantissa, W = 23 bits; for
//                                    posit32 W = 31, m << 8, so that the
//                                    stream never fits without a cut)
//
// the pattern's magnitude is the stream rounded to nearest even at its
// top N - 1 bits, which drops d >= 1 low bits:
//
//   |pattern| = head + (m + base + lsb) >> d,  lsb = ((m >> d) ^ head) & 1
//
// where head = stream >> d less the mantissa's share, and base = the
// field bits that fall among the dropped ones plus 2^(d-1) - 1 (so that
// the sum carries exactly when the dropped part exceeds half, or equals
// it with an odd body).  A negative f32 stores -head and a multiplier of
// -1, so the sign costs no instruction of its own: the pattern is head
// + mul * ((m + base + lsb) >> d), one IMAD.  The few posit32 exponents
// whose fields alone overrun 31 dropped bits fold their round and
// sticky bits into base at d = 31; saturated, NaR and zero/subnormal
// entries pick head, d and base so that the same two lines give maxpos,
// minpos, NaR, 0 or minpos.  No entry rounds past maxpos or down to
// zero.  The result's bits above N are junk for a negative pattern: the
// caller stores the low N bits.
struct alignas(16) F32Entry {
  uint32_t head;   // the pattern's fields (negated for a negative f32)
  uint32_t shift;  // d, the stream bits dropped, in [1, 31]
  uint32_t base;   // dropped field bits + 2^(d-1) - 1
  uint32_t mul;    // 1, or 0xFFFFFFFF for a negative f32
};

// the entry of biased exponent ``e8`` (0..255) for a positive f32
template <int N, int ES>
POSIT_HD F32Entry f32_entry(uint32_t e8) {
  constexpr int W = N == 32 ? 31 : 23;
  constexpr uint32_t maxpos = (1u << (N - 1)) - 1u;
  constexpr int max_scale = (N - 2) * (1 << ES);
  if (e8 == 255u) return {1u << (N - 1), 31u, 0u, 1u};            // NaR
  if (e8 == 0u) return {0u, static_cast<uint32_t>(W), (1u << W) - 1u, 1u};  // 0 or minpos
  const int exp = static_cast<int>(e8) - 127;
  if (exp > max_scale) return {maxpos, 31u, 0u, 1u};
  if (exp < -max_scale) return {1u, 31u, 0u, 1u};
  // floor division by 2^es without shifting a negative value
  const int r = exp >= 0 ? (exp >> ES) : -((-exp + (1 << ES) - 1) >> ES);
  const uint32_t e = static_cast<uint32_t>(exp - r * (1 << ES));
  const int len = (r >= 0 ? r + 2 : 1 - r) + ES;                  // regime + exponent bits
  // regime (r + 1 ones and a zero, or -r zeros and a one) and exponent
  const uint64_t fields = ((r >= 0 ? (2ull << (r + 1)) - 2ull : 1ull) << ES) | e;
  const int d = len + W - (N - 1);                                 // >= 2
  if (d <= 31) {
    const uint64_t placed = fields << W;                           // the stream less m
    return {static_cast<uint32_t>(placed >> d), static_cast<uint32_t>(d),
            static_cast<uint32_t>(placed & ((1ull << d) - 1ull)) + (1u << (d - 1)) - 1u, 1u};
  }
  // posit32 only: k = d - 31 field bits dropped besides all of m
  const int k = d - W;
  const uint32_t round = static_cast<uint32_t>(fields >> (k - 1)) & 1u;
  const bool rest = (fields & ((1ull << (k - 1)) - 1ull)) != 0ull;
  return {static_cast<uint32_t>(fields >> k), 31u,
          round ? (rest ? 0x80000000u : 0x7FFFFFFFu) : 0u, 1u};
}

// the entry of the same exponent for a negative f32
POSIT_HD F32Entry f32_negate(F32Entry t) {
  t.head = 0u - t.head;
  t.mul = 0xFFFFFFFFu;
  return t;
}

// the pattern (low N bits) of the f32 ``bits`` from its entry,
// ``f32_entry`` of ``bits >> 23`` (negated when the sign is set)
template <int N>
POSIT_HD uint32_t f32_round(const F32Entry& t, uint32_t bits) {
  const uint32_t m = N == 32 ? (bits << 8) & 0x7FFFFFFFu : bits & 0x7FFFFFu;
  const uint32_t lsb = ((m >> t.shift) ^ t.head) & 1u;
  return t.head + t.mul * ((m + t.base + lsb) >> t.shift);
}

// the table's two entries of biased exponent ``e8``: lut[e8] and, for
// the negative f32, lut[e8 + 256] (``lut`` indexed by ``bits >> 23``)
template <int N, int ES>
POSIT_HD void f32_fill(F32Entry* lut, uint32_t e8) {
  const F32Entry t = f32_entry<N, ES>(e8);
  lut[e8] = t;
  lut[e8 + 256u] = f32_negate(t);
}

// f32 bits -> posit pattern with the entry computed in place (the form
// the table is held to; the kernels read the entry from the table)
template <int N, int ES>
POSIT_HD uint32_t f32_to_posit(uint32_t bits) {
  const F32Entry t = f32_entry<N, ES>((bits >> 23) & 0xFFu);
  const uint32_t p = f32_round<N>(bits >> 31 ? f32_negate(t) : t, bits);
  return N < 32 ? p & ((1u << N) - 1u) : p;
}

}  // namespace posit
