"""64-bit unsigned values as (hi, lo) pairs of 32-bit lanes.

Each half is an int64 tensor in ``[0, 2**32)`` (see ``core/bits.py``);
every result is reduced mod 2**64 as the reference's uint32 pairs wrap,
and shifts are total.  The encoder (``core/pir.py``) assembles its
stream here; the arithmetic (``core/arith.py``, ``core/dot.py``) adds
the products, the sticky shifts and the truncating multiply of the
Newton-Raphson divider.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .bits import M32, clz32, sll, srl, u32


class U64(NamedTuple):
    hi: torch.Tensor
    lo: torch.Tensor


def make(hi, lo) -> U64:
    return U64(u32(hi), u32(lo))


def zeros_like(x: U64) -> U64:
    return U64(torch.zeros_like(x.hi), torch.zeros_like(x.lo))


def from32(lo) -> U64:
    lo = u32(lo)
    return U64(torch.zeros_like(lo), lo)


def add(a: U64, b: U64) -> U64:
    lo = a.lo + b.lo
    return U64((a.hi + b.hi + (lo >> 32)) & M32, lo & M32)


def sub(a: U64, b: U64) -> U64:
    borrow = (a.lo < b.lo).to(a.lo.dtype)
    return U64((a.hi - b.hi - borrow) & M32, (a.lo - b.lo) & M32)


def neg(a: U64) -> U64:
    """Two's complement: 2^64 - a (mod 2^64)."""
    return add(U64(~a.hi & M32, ~a.lo & M32), from32(torch.ones_like(a.lo)))


def bor(a: U64, b: U64) -> U64:
    return U64(a.hi | b.hi, a.lo | b.lo)


def band(a: U64, b: U64) -> U64:
    return U64(a.hi & b.hi, a.lo & b.lo)


def shl(a: U64, s) -> U64:
    """``a << s``; 0 for ``s`` outside ``[0, 64)``."""
    hi = sll(a.hi, s) | srl(a.lo, 32 - s) | sll(a.lo, s - 32)
    return U64(hi, sll(a.lo, s))


def shr(a: U64, s) -> U64:
    """Logical ``a >> s``; 0 for ``s`` outside ``[0, 64)``."""
    lo = srl(a.lo, s) | sll(a.hi, 32 - s) | srl(a.hi, s - 32)
    return U64(srl(a.hi, s), lo)


def shr_sticky(a: U64, s):
    """``(a >> s, sticky)``: sticky is 1 iff a shifted-out bit was set.
    ``s`` in ``[0, 64)``."""
    mask = sub(shl(from32(torch.ones_like(a.lo)), s),
               from32(torch.ones_like(a.lo)))          # 2^s - 1
    dropped = band(a, mask)
    return shr(a, s), ((dropped.hi | dropped.lo) != 0).to(a.lo.dtype)


def lt(a: U64, b: U64):
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def ge(a: U64, b: U64):
    return ~lt(a, b)


def eq(a: U64, b: U64):
    return (a.hi == b.hi) & (a.lo == b.lo)


def is_zero(a: U64):
    return (a.hi | a.lo) == 0


def select(cond, a: U64, b: U64) -> U64:
    return U64(torch.where(cond, a.hi, b.hi), torch.where(cond, a.lo, b.lo))


def clz64(a: U64):
    return torch.where(a.hi == 0, 32 + clz32(a.lo), clz32(a.hi))


def bit(a: U64, pos):
    """Bit ``pos`` (0..63) as {0, 1}."""
    return shr(a, pos).lo & 1


def mul_32x32(a, b) -> U64:
    """Full 32x32 -> 64 product from 16-bit limb partial products (each
    below 2**32, so int64 holds every intermediate exactly)."""
    a, b = u32(a), u32(b)
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    mid = a0 * b1 + a1 * b0                     # < 2^33
    lo = a0 * b0 + ((mid & 0xFFFF) << 16)
    hi = a1 * b1 + (mid >> 16) + (lo >> 32)
    return U64(hi & M32, lo & M32)


def mul_64x32_hi64(t: U64, x) -> U64:
    """``(t * x) >> 32`` mod 2^64, truncating: the high product plus the
    top half of the low one, whose low half is dropped (what narrow
    hardware does; the Newton-Raphson divider depends on it)."""
    a = mul_32x32(t.hi, x)                      # scale 2^32
    b = mul_32x32(t.lo, x)                      # scale 2^0
    return add(a, from32(b.hi))
