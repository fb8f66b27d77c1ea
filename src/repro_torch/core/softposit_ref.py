"""Exact Python golden model for posit arithmetic (SoftPosit-equivalent).

Used as the oracle in tests and benchmarks: pure-integer/Fraction math, no
floating point anywhere, so every result is *provably* correctly rounded.

Rounding rule (Posit Standard 2022 / SoftPosit): round to nearest; ties to
the pattern with LSB 0 (patterns are monotone in value, so pattern-RNE is
value-RNE); magnitudes below minpos round to minpos, above maxpos to
maxpos; no signed zero; NaR absorbs everything undefined.
"""
from __future__ import annotations

import functools
from fractions import Fraction

from .types import PositConfig

ZERO = "zero"
NAR = "nar"


def _decode_bits(pattern: int, n: int, es: int):
    """Pattern -> Fraction | ZERO | NAR, for arbitrary widths (used both
    for cfg widths and the (n+1)-bit rounding-midpoint extension)."""
    mask = (1 << n) - 1
    p = pattern & mask
    if p == 0:
        return ZERO
    if p == 1 << (n - 1):
        return NAR
    sign = (p >> (n - 1)) & 1
    if sign:
        p = (-p) & mask
    # regime
    bits = [(p >> i) & 1 for i in range(n - 2, -1, -1)]  # after the sign
    r0 = bits[0]
    k = 0
    for b in bits:
        if b == r0:
            k += 1
        else:
            break
    r = (k - 1) if r0 == 1 else -k
    rest = bits[k + 1:] if k < len(bits) else []          # skip terminator
    e_bits = rest[:es]
    e = 0
    for b in e_bits:
        e = (e << 1) | b
    e <<= (es - len(e_bits))                              # pad missing with 0
    f_bits = rest[es:]
    f = Fraction(0)
    for i, b in enumerate(f_bits):
        if b:
            f += Fraction(1, 2 ** (i + 1))
    scale = r * (1 << es) + e
    mag = (1 + f) * (Fraction(2) ** scale)
    return -mag if sign else mag


def decode_exact(pattern: int, cfg: PositConfig):
    """Pattern -> Fraction | ZERO | NAR."""
    return _decode_bits(pattern, cfg.nbits, cfg.es)


@functools.lru_cache(maxsize=None)
def _decode_cached(pattern: int, nbits: int, es: int):
    return _decode_bits(pattern, nbits, es)


def encode_exact(value, cfg: PositConfig) -> int:
    """Fraction | ZERO | NAR -> pattern, rounded like SoftPosit.

    SoftPosit (the paper's golden) rounds the *bit string* at n bits with
    RNE — equivalent to comparing against the (n+1)-bit extension pattern
    ``(lo << 1) | 1``, NOT against the value-space midpoint.  The two
    differ when regime growth cuts into exponent bits (tapered ulps).
    """
    if value is NAR:
        return cfg.nar_pattern
    if value is ZERO or value == 0:
        return 0
    v = Fraction(value)
    sign = v < 0
    mag = -v if sign else v

    n, es = cfg.nbits, cfg.es
    maxpos = _decode_cached(cfg.maxpos_pattern, n, es)
    minpos = _decode_cached(cfg.minpos_pattern, n, es)
    if mag >= maxpos:
        p = cfg.maxpos_pattern
    elif mag <= minpos:
        p = cfg.minpos_pattern
    else:
        # binary search: largest positive pattern with value <= mag
        lo, hi = 1, cfg.maxpos_pattern            # values are monotone
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if _decode_cached(mid, n, es) <= mag:
                lo = mid
            else:
                hi = mid - 1
        below = _decode_cached(lo, n, es)
        if below == mag:
            p = lo
        else:
            # bit-string midpoint: the (n+1)-bit posit (lo<<1)|1
            midpoint = _decode_cached((lo << 1) | 1, n + 1, es)
            if mag < midpoint:
                p = lo
            elif mag > midpoint:
                p = lo + 1
            else:                                  # tie -> even pattern
                p = lo if (lo & 1) == 0 else lo + 1
    if sign:
        p = (-p) & cfg.mask
    return p


def _binary(op, a: int, b: int, cfg: PositConfig) -> int:
    va = decode_exact(a, cfg)
    vb = decode_exact(b, cfg)
    if va is NAR or vb is NAR:
        return cfg.nar_pattern
    return op(va, vb)


def add(a: int, b: int, cfg: PositConfig) -> int:
    def op(va, vb):
        va = 0 if va is ZERO else va
        vb = 0 if vb is ZERO else vb
        return encode_exact(va + vb, cfg)
    return _binary(op, a, b, cfg)


def sub(a: int, b: int, cfg: PositConfig) -> int:
    def op(va, vb):
        va = 0 if va is ZERO else va
        vb = 0 if vb is ZERO else vb
        return encode_exact(va - vb, cfg)
    return _binary(op, a, b, cfg)


def mul(a: int, b: int, cfg: PositConfig) -> int:
    def op(va, vb):
        if va is ZERO or vb is ZERO:
            return 0
        return encode_exact(va * vb, cfg)
    return _binary(op, a, b, cfg)


def div(a: int, b: int, cfg: PositConfig) -> int:
    def op(va, vb):
        if vb is ZERO:
            return cfg.nar_pattern               # x/0 = NaR
        if va is ZERO:
            return 0
        return encode_exact(va / vb, cfg)
    return _binary(op, a, b, cfg)


def dot(a_vec, b_vec, cfg: PositConfig) -> int:
    """Exact real dot product, rounded once (quire semantics)."""
    total = Fraction(0)
    for a, b in zip(a_vec, b_vec):
        va = decode_exact(int(a), cfg)
        vb = decode_exact(int(b), cfg)
        if va is NAR or vb is NAR:
            return cfg.nar_pattern
        if va is ZERO or vb is ZERO:
            continue
        total += va * vb
    return encode_exact(total, cfg)


def from_float(x: float, cfg: PositConfig) -> int:
    """Exact f64 -> posit (floats are exact binary rationals)."""
    import math
    if math.isnan(x) or math.isinf(x):
        return cfg.nar_pattern
    if x == 0:
        return 0
    return encode_exact(Fraction(x), cfg)


def to_float(p: int, cfg: PositConfig) -> float:
    v = decode_exact(p, cfg)
    if v is NAR:
        return float("nan")
    if v is ZERO:
        return 0.0
    return float(v)
