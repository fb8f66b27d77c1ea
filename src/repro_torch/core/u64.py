"""64-bit unsigned values as (hi, lo) pairs of 32-bit lanes.

Only what the encoder (``core/pir.py``) needs: the 64-bit stream it
assembles regime, exponent and fraction into.  Each half is an int64
tensor in ``[0, 2**32)`` (see ``core/bits.py``); shifts are total.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .bits import M32, sll, srl, u32


class U64(NamedTuple):
    hi: torch.Tensor
    lo: torch.Tensor


def from32(lo) -> U64:
    lo = u32(lo)
    return U64(torch.zeros_like(lo), lo)


def sub(a: U64, b: U64) -> U64:
    borrow = (a.lo < b.lo).to(a.lo.dtype)
    return U64((a.hi - b.hi - borrow) & M32, (a.lo - b.lo) & M32)


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


def select(cond, a: U64, b: U64) -> U64:
    return U64(torch.where(cond, a.hi, b.hi), torch.where(cond, a.lo, b.lo))


def bit(a: U64, pos):
    """Bit ``pos`` (0..63) as {0, 1}."""
    return shr(a, pos).lo & 1
