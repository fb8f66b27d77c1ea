// Posit -> float32 for posits of at most 16 bits, without rounding.
//
// Every posit of at most 16 bits with es <= 2 is an f32 normal number:
// its scale lies in [-56, 56] and it carries at most 13 fraction bits.
// So its f32 pattern is sign | (scale + 127) << 23 | fraction, placed,
// with none of ``posit::to_f32``'s rounding and subnormal handling.  The
// result is bit-identical to ``posit::to_f32`` (and so to
// ``core/convert.py``) for every pattern; the kernels that decode in
// their inner loop (``paged_attn.cu``, ``posit_gemm.cu``) use this one.
//
// Header-only and free of CUDA types, like ``posit.cuh``, so a host
// compiler can check it against the codec over every pattern.
#pragma once

#include <stdint.h>

#include "posit.cuh"

namespace posit {

template <int N, int ES>
POSIT_HD float to_f32_narrow(uint32_t p) {
  static_assert(N <= 16 && ES <= 2, "narrow decode: N <= 16, es <= 2 only");
  // sign-extended pattern and its magnitude (NaR: 2^(N-1))
  const int32_t sx = static_cast<int32_t>(p << (32 - N)) >> (32 - N);
  const uint32_t ax = static_cast<uint32_t>(sx < 0 ? -sx : sx);
  const uint32_t y = ax << (33 - N);                 // regime from bit 31
  // the regime's run: leading bits equal to bit 31
  const int run = clz32(y ^ static_cast<uint32_t>(static_cast<int32_t>(y) >> 31));
  const int k = run < N - 1 ? run : N - 1;
  const uint32_t rest = (y << 1) << k;               // exponent, fraction
  // exponent field: regime * 2^es + 127; the es exponent bits of `rest`
  // land on the field's low bits by addition, the fraction below them
  const int field = (y >> 31) ? (k - 1) * (1 << ES) + 127 : 127 - k * (1 << ES);
  const uint32_t bits = (static_cast<uint32_t>(field) << 23) + (rest >> (9 - ES));
  const uint32_t out = bits | (static_cast<uint32_t>(sx) & 0x80000000u);
  // zero and NaR are the patterns whose magnitude leaves y == 0
  return bits_f32(y != 0u ? out : (sx < 0 ? 0x7FC00000u : 0u));
}

}  // namespace posit
