// The PVU datapath for one element (or one product), on native integers.
//
// Shared by the port's four ISA kernels (posit_ew.cu, posit_dot.cu,
// posit_qgemm.cu; posit_gemm.cu decodes through posit.cuh).  It is the
// arithmetic of ``repro_torch/core/{pir,arith,dot}.py`` -- which emulate
// 64-bit lanes with pairs of 32-bit ones -- on ``uint64_t`` and
// ``unsigned __int128``:
//
//   decode      pattern -> PIR (sign, combined exponent, Q1.31
//               significand with the hidden bit, zero, NaR);
//   encode      PIR + sticky -> pattern, one round to nearest even;
//   add/sub/mul and div (``nr3``: the paper's Newton-Raphson with its
//               truncations kept exactly; ``exact``: 33-step restoring);
//   the quire   128-bit two's-complement window per tile: products
//               aligned to the tile's largest exponent and floored,
//               tiles folded in order by a floor shift, one rounding.
//
// Results must be bit-identical to the Python versions for every input:
// every truncation below is the reference's, not a better one.
//
// Header-only and free of CUDA types (beyond the intrinsics behind
// __CUDA_ARCH__), so a host compiler builds it for exhaustive checks
// (tests/test_torch_csrc_host.py).
#pragma once

#include <stdint.h>

#include "posit.cuh"

namespace pvu {

using u128 = unsigned __int128;
using posit::clampi;
using posit::clz32;
using posit::sll64;
using posit::srl64;

constexpr int kExpSentinel = -(1 << 28);  // stands in for -inf (zero)
constexpr int kMaxDotLength = 4096;       // quire tile (core/dot.py)

enum Op { kAdd = 0, kSub = 1, kMul = 2, kDivNr3 = 3, kDivExact = 4 };

struct Pir {
  uint32_t sign;
  int exp;
  uint32_t sig;
  bool zero;
  bool nar;
};

struct Quire {
  u128 acc;      // two's complement, the tile max product's MSB at bit 95
  int m_exp;     // alignment exponent; kExpSentinel when empty
  uint32_t sticky;
  bool nar;
};

// x << s and x >> s, 0 for any s outside [0, 32) (posit::sll32 and
// srl32): one clamped funnel shift on the card, no compare and select
POSIT_HD uint32_t shl(uint32_t x, int s) {
#ifdef __CUDA_ARCH__
  return __funnelshift_lc(0u, x, static_cast<unsigned>(s));
#else
  return posit::sll32(x, s);
#endif
}

POSIT_HD uint32_t shr(uint32_t x, int s) {
#ifdef __CUDA_ARCH__
  return __funnelshift_rc(x, 0u, static_cast<unsigned>(s));
#else
  return posit::srl32(x, s);
#endif
}

POSIT_HD int clz64(uint64_t x) {
  const uint32_t hi = static_cast<uint32_t>(x >> 32);
  return hi ? clz32(hi) : 32 + clz32(static_cast<uint32_t>(x));
}

POSIT_HD int clz128(u128 x) {
  const uint64_t hi = static_cast<uint64_t>(x >> 64);
  return hi ? clz64(hi) : 64 + clz64(static_cast<uint64_t>(x));
}

// core/pir.py::decode
template <int N, int ES>
POSIT_HD Pir decode(uint32_t p) {
  const uint32_t mask = N < 32 ? ((1u << N) - 1u) : 0xFFFFFFFFu;
  const uint32_t x = p & mask;
  Pir r;
  r.zero = x == 0u;
  r.nar = x == (1u << (N - 1));
  r.sign = 0u;
  r.exp = 0;
  r.sig = 0u;
  if (r.zero || r.nar) return r;
  const uint32_t sign = (x >> (N - 1)) & 1u;
  const uint32_t ax = sign ? ((~x + 1u) & mask) : x;
  const uint32_t y = ax << (32 - N);                 // sign at bit 31
  const uint32_t r0 = (y >> 30) & 1u;
  const uint32_t t = ((r0 ? ~y : y) & 0x7FFFFFFFu) << 1;
  const int run = clz32(t);
  const int k = run < N - 1 ? run : N - 1;           // regime run length
  const int reg = r0 ? k - 1 : -k;
  const uint32_t body = shl(y, k + 2);
  const uint32_t e = ES > 0 ? (body >> (32 - ES)) : 0u;
  r.sign = sign;
  r.sig = 0x80000000u | (posit::sll32(body, ES) >> 1);
  r.exp = reg * (1 << ES) + static_cast<int>(e);
  return r;
}

// core/pir.py::encode on 32-bit words.  The pattern reads the top N + 1
// bits of that encode's 64-bit stream (the body and the round bit) and an
// OR of the bits below them, so the stream's top word and a sticky of its
// low word give the same pattern for every N <= 32.  The regime (at most
// 32 bits: |exp| is clamped to (N - 2) 2^ES) lies in the top word; the
// exponent field and the fraction straddle the two words.  The 64-bit
// stream form is the reference in tests/test_torch_csrc_host.py that
// test_encode_fields_equals_posit_encode holds this one to.
template <int N, int ES>
POSIT_HD uint32_t encode_fields(uint32_t sign, int exp, uint32_t sig, uint32_t sticky) {
  const uint32_t mask = N < 32 ? ((1u << N) - 1u) : 0xFFFFFFFFu;
  const uint32_t maxpos = (1u << (N - 1)) - 1u;
  const int max_scale = (N - 2) * (1 << ES);
  const bool too_big = exp > max_scale;
  const bool too_small = exp < -max_scale;
  const int expc = clampi(exp, -max_scale, max_scale);
  // floor division by 2^es without shifting a negative value
  const int r = expc >= 0 ? (expc >> ES) : -((-expc + (1 << ES) - 1) >> ES);
  const uint32_t e = static_cast<uint32_t>(expc - r * (1 << ES));
  const int reg_len = r >= 0 ? r + 2 : 1 - r;        // in [2, N]
  const uint32_t v_reg = r >= 0 ? shl(2u, r + 1) - 2u : 1u;
  uint32_t top = v_reg << (32 - reg_len);
  uint32_t low = sticky;                             // nonzero: a bit in the low word
  if (ES > 0) {
    const int esh = 32 - reg_len - ES;               // e's LSB in the top word
    top |= esh >= 0 ? shl(e, esh) : shr(e, -esh);
    if (esh < 0) low |= e & (shl(1u, -esh) - 1u);
  }
  const uint32_t frac31 = sig & 0x7FFFFFFFu;
  const int fr = reg_len + ES - 1;                   // fraction bits below the top word
  top |= shr(frac31, fr);
  low |= frac31 & (shl(1u, fr) - 1u);

  const uint32_t body = top >> (33 - N);
  const uint32_t round_bit = (top >> (32 - N)) & 1u;
  const uint32_t sticky_rest =
      ((N < 32 ? (top & ((1u << (32 - N)) - 1u)) : 0u) | low) != 0u ? 1u : 0u;
  uint32_t p = body + (round_bit & (sticky_rest | (body & 1u)));
  p = p > maxpos ? maxpos : p;                       // never past maxpos
  p = p < 1u ? 1u : p;                               // never to zero
  if (too_big) p = maxpos;
  if (too_small) p = 1u;
  if (sign) p = (~p + 1u) & mask;
  return p;
}

// core/pir.py::encode_pir
template <int N, int ES>
POSIT_HD uint32_t encode(const Pir& r, uint32_t sticky) {
  if (r.nar) return 1u << (N - 1);
  if (r.zero) return 0u;
  return encode_fields<N, ES>(r.sign, r.exp, r.sig, sticky);
}

// u64.shr_sticky for d in [0, 63]
POSIT_HD uint64_t shr_sticky(uint64_t m, int d, uint32_t* st) {
  *st = (m & (sll64(1ull, d) - 1ull)) != 0ull;
  return srl64(m, d);
}

// arith.py::_normalize_u64: MSB to bit 62 -> (sig, exp, sticky)
POSIT_HD void normalize(uint64_t mag, int exp, uint32_t sticky, uint32_t* sig,
                        int* exp_out, uint32_t* st_out) {
  const int lz = mag ? clz64(mag) : 64;
  uint64_t out;
  if (lz == 0) {
    out = mag >> 1;
    sticky |= static_cast<uint32_t>(mag & 1ull);
  } else {
    out = sll64(mag, lz - 1);
  }
  *exp_out = exp + 1 - lz;
  *sig = static_cast<uint32_t>(out >> 31);           // bits 62..31
  *st_out = sticky | ((out & 0x7FFFFFFFull) != 0ull);
}

// arith.py::vpadd (align_width 63: exactly rounded)
POSIT_HD Pir add(const Pir& a, const Pir& b, uint32_t* sticky) {
  const int ea = a.zero ? kExpSentinel : a.exp;
  const int eb = b.zero ? kExpSentinel : b.exp;
  const int exp_t = ea > eb ? ea : eb;
  uint32_t st_a, st_b;
  const uint64_t m_a = shr_sticky(static_cast<uint64_t>(a.sig) << 31,
                                  clampi(exp_t - ea, 0, 63), &st_a);
  const uint64_t m_b = shr_sticky(static_cast<uint64_t>(b.sig) << 31,
                                  clampi(exp_t - eb, 0, 63), &st_b);
  const bool same = a.sign == b.sign;
  const bool a_ge_b = m_a >= m_b;
  const uint32_t st = st_a | st_b;
  uint64_t diff = a_ge_b ? m_a - m_b : m_b - m_a;
  if (!same && st == 1u) diff -= 1ull;               // floor of a truncated tail
  const uint64_t mag = same ? m_a + m_b : diff;
  const bool out_zero = mag == 0ull && st == 0u;

  Pir r;
  uint32_t s;
  normalize(mag, exp_t, st, &r.sig, &r.exp, &s);
  r.sign = out_zero ? 0u : (same ? a.sign : (a_ge_b ? a.sign : b.sign));
  r.zero = out_zero;
  r.nar = a.nar || b.nar;
  if (a.zero || b.zero) {                            // the other passes through
    const Pir& o = a.zero ? b : a;
    r.sign = o.sign;
    r.exp = o.exp;
    r.sig = o.sig;
    r.zero = o.zero;
    s = 0u;
  }
  *sticky = s;
  return r;
}

POSIT_HD Pir negate(Pir p) {
  if (!(p.zero || p.nar)) p.sign ^= 1u;
  return p;
}

// arith.py::vpmul
POSIT_HD Pir mul(const Pir& a, const Pir& b, uint32_t* sticky) {
  const uint64_t prod = static_cast<uint64_t>(a.sig) * b.sig;   // Q2.62
  const bool hi_set = (prod >> 63) != 0ull;
  Pir r;
  r.zero = a.zero || b.zero;
  r.nar = a.nar || b.nar;
  r.sign = (r.zero || r.nar) ? 0u : (a.sign ^ b.sign);
  r.exp = a.exp + b.exp + (hi_set ? 1 : 0);
  r.sig = hi_set ? static_cast<uint32_t>(prod >> 32) : static_cast<uint32_t>(prod >> 31);
  *sticky = hi_set ? (static_cast<uint32_t>(prod) != 0u)
                   : ((prod & 0x7FFFFFFFull) != 0ull);
  if (r.zero) {
    r.sig = 0u;
    *sticky = 0u;
  }
  return r;
}

// arith.py::_nr_reciprocal: x0 = 48/17 - 32/17 c, three truncating
// iterations x <- x (2 - c x); the low half of t.lo * x is dropped
constexpr uint64_t kK1Q31 = 6063483241ull;          // round(48/17 * 2^31)
constexpr uint64_t kK2Q31 = 4042322161ull;          // round(32/17 * 2^31)

POSIT_HD uint32_t nr_reciprocal(uint32_t sig_b) {
  const uint32_t term = static_cast<uint32_t>((kK2Q31 * sig_b) >> 32);
  uint32_t x = static_cast<uint32_t>(kK1Q31 - term);
  for (int it = 0; it < 3; ++it) {
    const uint64_t tm = 0ull - static_cast<uint64_t>(sig_b) * x;
    const uint64_t hi = static_cast<uint64_t>(static_cast<uint32_t>(tm >> 32)) * x +
                        ((static_cast<uint64_t>(static_cast<uint32_t>(tm)) * x) >> 32);
    x = static_cast<uint32_t>(hi >> 31);
  }
  return x;
}

// arith.py::_div_exact_sig: 33 restoring steps, remainder -> sticky
POSIT_HD void div_exact_sig(uint32_t sig_a, uint32_t sig_b, uint32_t* sig,
                            int* exp_adj, uint32_t* sticky) {
  const uint64_t den = sig_b;
  const bool ge0 = sig_a >= sig_b;
  uint64_t q = ge0 ? 1ull : 0ull;
  uint64_t rem = ge0 ? static_cast<uint64_t>(sig_a - sig_b) : sig_a;
  for (int i = 0; i < 33; ++i) {
    rem <<= 1;
    const bool geq = rem >= den;
    if (geq) rem -= den;
    q = (q << 1) + (geq ? 1ull : 0ull);
  }
  uint32_t st = rem != 0ull;
  const bool bit33 = ((q >> 33) & 1ull) != 0ull;
  const int sh = bit33 ? 2 : 1;
  *sig = static_cast<uint32_t>(q >> sh);
  st |= (q & ((1ull << sh) - 1ull)) != 0ull;
  *sticky = st;
  *exp_adj = bit33 ? 0 : -1;
}

// arith.py::vpdiv
template <bool kExact>
POSIT_HD Pir div(const Pir& a, const Pir& b, uint32_t* sticky) {
  Pir r;
  uint32_t st;
  if (kExact) {
    int adj;
    div_exact_sig(a.sig, b.sig, &r.sig, &adj, &st);
    r.exp = a.exp - b.exp + adj;
  } else {
    const uint32_t x = nr_reciprocal(b.sig);
    normalize(static_cast<uint64_t>(a.sig) * x, a.exp - b.exp, 0u, &r.sig, &r.exp, &st);
    r.exp -= 1;                                      // fold the factor of 2
    if (b.sig == 0x80000000u) {                      // power of two: exact
      r.sig = a.sig;
      st = 0u;
      r.exp = a.exp - b.exp;
    }
  }
  r.nar = a.nar || b.nar || b.zero;                  // x/0 = NaR
  r.zero = a.zero && !b.zero;
  r.sign = (r.zero || r.nar) ? 0u : (a.sign ^ b.sign);
  if (r.zero) {
    r.sig = 0u;
    st = 0u;
  }
  *sticky = st;
  return r;
}

template <int OP>
POSIT_HD Pir binary(const Pir& a, const Pir& b, uint32_t* sticky) {
  if (OP == kAdd) return add(a, b, sticky);
  if (OP == kSub) return add(a, negate(b), sticky);
  if (OP == kMul) return mul(a, b, sticky);
  return div<OP == kDivExact>(a, b, sticky);
}

// One elementwise op on two decoded operands -> pattern (a kernel
// decodes a scalar operand once and passes it here for every element).
template <int N, int ES, int OP>
POSIT_HD uint32_t elementwise_pir(const Pir& a, const Pir& b) {
  uint32_t sticky;
  const Pir r = binary<OP>(a, b, &sticky);
  return encode<N, ES>(r, sticky);
}

// One elementwise op on two patterns (the fused vadd/vsub/vmul/vdiv).
template <int N, int ES, int OP>
POSIT_HD uint32_t elementwise(uint32_t pa, uint32_t pb) {
  return elementwise_pir<N, ES, OP>(decode<N, ES>(pa), decode<N, ES>(pb));
}

// ---------------------------------------------------------------------
// Quire-lite (core/dot.py): per tile, pass 1 takes the largest product
// exponent, pass 2 places every product against it and sums mod 2^128.
// ---------------------------------------------------------------------

// The exponent a product takes part in the tile maximum with.
POSIT_HD int product_exp(const Pir& a, const Pir& b) {
  return (a.zero || b.zero) ? kExpSentinel : a.exp + b.exp;
}

// dot.py::quire_partial, one product: (p * 2^32) >> d as a 128-bit
// two's-complement contribution, floored; dropped bits set *st.  The
// plain form; the kernels add through place_add.
POSIT_HD u128 place_product(const Pir& a, const Pir& b, int m_exp, uint32_t* st) {
  *st = 0u;
  if (a.zero || b.zero) return 0;
  const uint64_t p = static_cast<uint64_t>(a.sig) * b.sig;      // Q2.62
  const int d = clampi(m_exp - (a.exp + b.exp), 0, 95);
  u128 v = (static_cast<u128>(p) << 32) >> d;
  if (d > 32) *st = (p & ((1ull << (d - 32)) - 1ull)) != 0ull;
  if (a.sign ^ b.sign) v = static_cast<u128>(0) - v - *st;     // floor of -(v + tail)
  return v;
}

// (hi:lo) >> r, the low word; r in [0, 31]
POSIT_HD uint32_t fshr(uint32_t lo, uint32_t hi, int r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, r);
#else
  return static_cast<uint32_t>(((static_cast<uint64_t>(hi) << 32) | lo) >> r);
#endif
}

// A tile's running sum in the kernels: the 128-bit sum is acc + ones,
// the +1s of the negated products counted apart from the carry chain.
struct TileSum {
  u128 acc;
  uint32_t ones;
  uint32_t sticky;
};

POSIT_HD TileSum tile_sum_empty() {
  TileSum t;
  t.acc = 0;
  t.ones = 0u;
  t.sticky = 0u;
  return t;
}

// place_product fused with the sum, on 32-bit words: adds to t what
// place_product(a, b, m_exp, &st) adds (and st to the sticky), bit for
// bit, from the significands (0 for zero and NaR, so p = 0 places
// nothing, as place_product's zero test does), the exponent distance
// d = m_exp - (a.exp + b.exp) and the product's sign.  (p * 2^32) >> d
// is the 96-bit (ph:pl:0) shifted right by q = d / 32 words and r bits;
// a negative product adds ~v + 1 - st, the floor of -(v + tail).  No
// 128-bit variable shift, negate or branch: funnel shifts, selects, the
// sign flip as a multiply-add (the FMA pipe, beside the integer ALU the
// rest keeps busy) and one 128-bit add; place_product stays the plain
// form it is tested against.  kNarrow (posits of at most 16 bits, whose
// significands have 16 low zero bits) takes sig >> 16 of both operands:
// the product then fits ph, and pl is 0.
template <bool kNarrow>
POSIT_HD void place_add(TileSum* t, uint32_t sig_a, uint32_t sig_b, int d, uint32_t neg) {
  uint32_t pl, ph;
  if (kNarrow) {
    pl = 0u;
    ph = sig_a * sig_b;
  } else {
    const uint64_t p = static_cast<uint64_t>(sig_a) * sig_b;    // Q2.62
    pl = static_cast<uint32_t>(p);
    ph = static_cast<uint32_t>(p >> 32);
  }
  d = clampi(d, 0, 95);
  const int q = d >> 5, r = d & 31;
  const uint32_t x0 = fshr(0u, pl, r), x1 = fshr(pl, ph, r), x2 = ph >> r;
  const uint32_t x3 = fshr(0u, ph, r);                  // ph's low r bits
  const uint32_t v0 = q == 0 ? x0 : (q == 1 ? x1 : x2);
  const uint32_t v1 = q == 0 ? x1 : (q == 1 ? x2 : 0u);
  const uint32_t v2 = q == 0 ? x2 : 0u;
  // the dropped bits: none at q 0, pl's low r at q 1, pl and ph's low r at q 2
  const uint32_t dropped = q == 0 ? 0u : (q == 1 ? x0 : (pl | x3));
  const uint32_t st = dropped != 0u ? 1u : 0u;
  // v ^ m as v * (1 + 2m) + m: v, or ~v when m is all ones
  const uint32_t m = 0u - neg, f = 1u + 2u * m;
  t->acc += (static_cast<u128>(m) << 96) | (static_cast<u128>(v2 * f + m) << 64) |
            (static_cast<u128>(v1 * f + m) << 32) | (v0 * f + m);
  t->ones += neg & (st ^ 1u);
  t->sticky |= st;
}

// The significand place_add<kNarrow> takes.
template <bool kNarrow>
POSIT_HD uint32_t place_sig(uint32_t sig) {
  return kNarrow ? sig >> 16 : sig;
}

POSIT_HD Quire quire_empty() {
  Quire q;
  q.acc = 0;
  q.m_exp = kExpSentinel;
  q.sticky = 0u;
  q.nar = false;
  return q;
}

// dot.py::_asr128_sticky: floor shift by s >= 0 (clamped at 128)
POSIT_HD u128 asr128_sticky(u128 x, int s, uint32_t* st) {
  const bool neg = (x >> 127) != 0;
  if (s <= 0) {
    *st = 0u;
    return x;
  }
  if (s >= 128) {
    *st = x != 0;
    return neg ? ~static_cast<u128>(0) : static_cast<u128>(0);
  }
  *st = (x & ((static_cast<u128>(1) << s) - 1)) != 0;
  u128 r = x >> s;
  if (neg) r |= ~(~static_cast<u128>(0) >> s);
  return r;
}

// dot.py::quire_combine (an empty state is absorbed untouched)
POSIT_HD Quire quire_combine(const Quire& s, const Quire& t) {
  Quire r;
  r.m_exp = s.m_exp > t.m_exp ? s.m_exp : t.m_exp;
  uint32_t st_a, st_b;
  const u128 sa = asr128_sticky(s.acc, r.m_exp - s.m_exp, &st_a);
  const u128 tb = asr128_sticky(t.acc, r.m_exp - t.m_exp, &st_b);
  r.acc = sa + tb;
  r.sticky = s.sticky | t.sticky | st_a | st_b;
  r.nar = s.nar || t.nar;
  return r;
}

// dot.py::quire_finalize + encode: the one rounding of a reduction
template <int N, int ES>
POSIT_HD uint32_t quire_finalize(const Quire& q) {
  u128 acc = q.acc;
  uint32_t sticky = q.sticky;
  const uint32_t sign = static_cast<uint32_t>(acc >> 127);
  if (sign) acc = static_cast<u128>(0) - acc;
  Pir r;
  r.zero = acc == 0 && sticky == 0u;
  r.nar = q.nar;
  const int lz = acc == 0 ? 128 : clz128(acc);
  uint32_t top = 0u;
  if (acc != 0) {
    const u128 sh = acc << lz;                       // MSB at bit 127
    top = static_cast<uint32_t>(sh >> 96);
    sticky |= (sh & ((static_cast<u128>(1) << 96) - 1)) != 0;
  }
  r.sign = r.zero ? 0u : sign;
  r.exp = r.zero ? 0 : q.m_exp + 33 - lz;
  r.sig = r.zero ? 0u : top;
  return encode<N, ES>(r, sticky);
}

}  // namespace pvu
