"""PVU dot product (§IV-E) on torch tensors: the streamable quire-lite.

The reference's ``repro/core/dot.py`` on 32-bit lanes held in int64
tensors.  Products stay unrounded in Q2.62, are aligned to the tile's
largest product exponent (each floored, dropped bits -> sticky; a
negative product with a dropped tail takes one more away), placed at
bits 95..32 of a 128-bit two's-complement window and summed mod 2^128
by 16-bit half-limb column sums; the sum is normalized and rounded once.

The accumulator state (``QuireState``: four 32-bit limbs, the alignment
exponent, sticky, NaR) is carried across tiles of ``MAX_DOT_LENGTH``
by ``quire_combine`` (floor-shift both subtotals to the larger exponent
and add), starting at element 0 and folding tiles in order, so any
reduction length rounds once.  A different tiling changes results
whenever a combine drops a nonzero bit.

``vpdot_quire`` is the Posit Standard's exact 512-bit quire: products
at absolute positions, no alignment and no sticky, so the sum is exact
and order-independent (plain tensor code only).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import u64
from .bits import M32, clz32, sll, srl
from .pir import PIR
from .types import PositConfig

_EXP_SENTINEL = -(1 << 28)
MAX_DOT_LENGTH = 4096
_NLIMB = 4  # 128-bit accumulator


def _place_product(p: u64.U64, d):
    """``(p * 2^32) >> d`` as 128-bit limbs [x3..x0] + sticky; d in
    [0, 95]."""
    top = u64.shr(p, d)                  # d <= 63: top 64 bits
    spill = u64.shl(p, 64 - d)           # the dropped bits, MSB-aligned
    st1 = (spill.lo != 0).to(p.lo.dtype)
    low, st2 = u64.shr_sticky(p, d - 32)  # 64 <= d <= 95
    near = d < 64
    x2 = torch.where(near, top.hi, 0)
    x1 = torch.where(near, top.lo, low.hi)
    x0 = torch.where(near, spill.hi, low.lo)
    return [torch.zeros_like(x2), x2, x1, x0], torch.where(near, st1, st2)


def _neg_n(limbs):
    """Two's complement of a limb vector (MSB-first)."""
    out = []
    carry = torch.ones_like(limbs[0])
    for x in reversed(limbs):
        t = ((~x & M32) + carry) & M32
        carry = ((x == 0) & (carry == 1)).to(x.dtype)
        out.append(t)
    return list(reversed(out))


def _sub1_128(limbs, dec):
    """Subtract a {0, 1} value from 128-bit limbs (MSB-first)."""
    out = []
    borrow = dec
    for x in reversed(limbs):
        out.append((x - borrow) & M32)
        borrow = (x < borrow).to(x.dtype)
    return list(reversed(out))


def _sum_n(limbs, dim):
    """Sum limb vectors along ``dim`` mod 2^(32 n) by 16-bit half-limb
    column sums (exact in int64) and one carry pass."""
    halves = []
    for x in reversed(limbs):            # LSB-first halves
        halves.append(x & 0xFFFF)
        halves.append(x >> 16)
    carry = 0
    out16 = []
    for h in halves:
        t = h.sum(dim=dim) + carry
        out16.append(t & 0xFFFF)
        carry = t >> 16
    out = [out16[2 * j] | (out16[2 * j + 1] << 16) for j in range(len(limbs))]
    return list(reversed(out))


def _clz_n(limbs):
    result = torch.full_like(limbs[0], 32 * len(limbs))
    found = torch.zeros_like(limbs[0], dtype=torch.bool)
    for off, x in enumerate(limbs):      # MSB-first
        result = torch.where((~found) & (x != 0), 32 * off + clz32(x), result)
        found = found | (x != 0)
    return result


def _top_and_rest(limbs, lz):
    """For 128-bit limbs shifted left by ``lz`` (MSB at bit 127): bits
    127..96, and whether any bit below 96 is set."""
    top = torch.zeros_like(limbs[0])
    rest_nonzero = torch.zeros_like(limbs[0], dtype=torch.bool)
    nbits = 32 * _NLIMB
    for idx, x in enumerate(limbs):      # MSB-first
        off = 32 * (_NLIMB - 1 - idx)    # limb bit offset: 96, 64, 32, 0
        s = off + lz - (nbits - 32)      # alignment into the top word
        top = top | torch.where(s >= 0, sll(x, s), srl(x, -s))
        # width of this limb's bits that land below bit 96; w <= 0 means
        # none (and must not build a mask from a negative width)
        w = (nbits - 32) - (off + lz)
        mask = (sll(1, w) - 1) & M32
        nz = torch.where(w >= 32, x != 0,
                         torch.where(w > 0, (x & mask) != 0, False))
        rest_nonzero = rest_nonzero | nz
    return top, rest_nonzero


def _add_n(a, b):
    """Add two equal-width limb vectors (MSB-first) mod 2^(32 n)."""
    out = []
    carry = 0
    for x, y in zip(reversed(a), reversed(b)):    # LSB-first
        t = x + y + carry
        out.append(t & M32)
        carry = t >> 32
    return list(reversed(out))


def _asr128_sticky(limbs, s):
    """Arithmetic (floor) shift right of a 128-bit two's-complement value
    by ``s >= 0`` (clamped at 128), limbs MSB-first -> (limbs, sticky):
    sticky is 1 iff a dropped bit was set."""
    s = s.clamp(0, 32 * _NLIMB)
    fill = torch.where((limbs[0] >> 31) != 0, M32, 0)
    lsb = list(reversed(limbs))          # lsb[j] covers bits 32j..32j+31
    w = s >> 5                           # whole-limb shift, 0..4
    r = s & 31
    out_lsb = []
    for idx in range(_NLIMB):
        res = fill
        for wv in range(_NLIMB + 1):
            lo = lsb[idx + wv] if idx + wv < _NLIMB else fill
            hi = lsb[idx + wv + 1] if idx + wv + 1 < _NLIMB else fill
            val = srl(lo, r) | sll(hi, 32 - r)    # r == 0: sll(hi, 32) == 0
            res = torch.where(w == wv, val, res)
        out_lsb.append(res)
    sticky = torch.zeros_like(limbs[0])
    for j in range(_NLIMB):              # bits of lsb[j] strictly below s
        t = s - 32 * j
        mask = (sll(1, t.clamp(0, 31)) - 1) & M32
        below = torch.where(t >= 32, lsb[j] != 0, (lsb[j] & mask) != 0)
        sticky = sticky | below.to(sticky.dtype)
    return list(reversed(out_lsb)), sticky


# ---------------------------------------------------------------------------
# Streamable quire-lite: QuireState + partial / combine / finalize
# ---------------------------------------------------------------------------

class QuireState(NamedTuple):
    """acc: (..., 4) limbs MSB-first (the max-exponent product's MSB at
    bit 95); m_exp: alignment exponent, ``-(1 << 28)`` when empty;
    sticky: {0, 1}; nar: bool."""
    acc: torch.Tensor
    m_exp: torch.Tensor
    sticky: torch.Tensor
    nar: torch.Tensor


def _unstack_acc(acc):
    return [acc[..., j] for j in range(_NLIMB)]


def quire_partial(a: PIR, b: PIR, dim: int = -1) -> QuireState:
    """One tile of ``sum_i a_i * b_i`` along ``dim`` into a QuireState
    (the operands broadcast against each other)."""
    length = torch.broadcast_shapes(a.sig.shape, b.sig.shape)[dim]
    if length > MAX_DOT_LENGTH:
        raise ValueError(
            f"quire_partial tile length {length} exceeds MAX_DOT_LENGTH="
            f"{MAX_DOT_LENGTH} (half-limb column-sum bound); chunk the "
            "reduction -- vpdot and the kernels do this")
    psign = a.sign ^ b.sign
    pzero = a.is_zero | b.is_zero
    any_nar = (a.is_nar | b.is_nar).any(dim=dim)

    prod = u64.mul_32x32(a.sig, b.sig)                   # Q2.62
    prod = u64.select(pzero, u64.zeros_like(prod), prod)
    pexp = torch.where(pzero, _EXP_SENTINEL, a.exp + b.exp)

    m_exp = pexp.amax(dim=dim, keepdim=True)
    d = (m_exp - pexp).clamp(0, 95)
    limbs, st = _place_product(prod, d)
    st = torch.where(pzero, 0, st)
    sticky = st.amax(dim=dim)

    neg = psign == 1
    limbs = [torch.where(neg, n, p) for n, p in zip(_neg_n(limbs), limbs)]
    # a negative product with a truncated tail: true = -(mag + delta),
    # floor = -mag - 1 (sticky carries the fraction)
    limbs = _sub1_128(limbs, (neg & (st == 1)).to(st.dtype))

    acc = _sum_n(limbs, dim)
    return QuireState(acc=torch.stack(acc, dim=-1),
                      m_exp=m_exp.squeeze(dim), sticky=sticky, nar=any_nar)


def quire_combine(s: QuireState, t: QuireState) -> QuireState:
    """Merge two partial states: floor-shift each subtotal to the larger
    exponent (dropped bits -> sticky) and add mod 2^128."""
    m = torch.maximum(s.m_exp, t.m_exp)
    sa, st_a = _asr128_sticky(_unstack_acc(s.acc), m - s.m_exp)
    tb, st_b = _asr128_sticky(_unstack_acc(t.acc), m - t.m_exp)
    return QuireState(acc=torch.stack(_add_n(sa, tb), dim=-1), m_exp=m,
                      sticky=s.sticky | t.sticky | st_a | st_b,
                      nar=s.nar | t.nar)


def quire_finalize(state: QuireState):
    """Normalize and extract the significand -> (PIR, sticky); the one
    rounding happens at ``pir.encode_pir``."""
    acc = _unstack_acc(state.acc)
    sticky = state.sticky

    sign_out = (acc[0] >> 31) & 1
    acc = [torch.where(sign_out == 1, n, p) for n, p in zip(_neg_n(acc), acc)]

    nonzero = acc[0]
    for x in acc[1:]:
        nonzero = nonzero | x
    is_zero = (nonzero == 0) & (sticky == 0)

    # value = mag128 * 2^(m_exp - 94); MSB -> bit 127, sig = bits 127..96
    lz = _clz_n(acc)
    exp_out = state.m_exp + 33 - lz
    top, rest_nz = _top_and_rest(acc, lz)
    sticky = sticky | rest_nz.to(sticky.dtype)

    pir = PIR(sign=torch.where(is_zero, 0, sign_out),
              exp=torch.where(is_zero, 0, exp_out),
              sig=torch.where(is_zero, 0, top),
              is_zero=is_zero, is_nar=state.nar)
    return pir, sticky


def _move_last(p: PIR, dim: int) -> PIR:
    return PIR(*(torch.movedim(f, dim, -1) for f in p))


def _iter_chunks(a: PIR, b: PIR, length: int):
    for start in range(0, length, MAX_DOT_LENGTH):
        stop = min(start + MAX_DOT_LENGTH, length)
        yield (PIR(*(f[..., start:stop] for f in a)),
               PIR(*(f[..., start:stop] for f in b)))


def _broadcast(a: PIR, b: PIR):
    shape = torch.broadcast_shapes(a.sig.shape, b.sig.shape)
    return (PIR(*(f.expand(shape) for f in a)),
            PIR(*(f.expand(shape) for f in b)))


def vpdot(a: PIR, b: PIR, cfg: PositConfig, dim: int = -1):
    """``sum_i a_i * b_i`` along ``dim`` -> (PIR, sticky), rounded once;
    any length, in tiles of MAX_DOT_LENGTH folded in order."""
    del cfg
    a, b = _broadcast(a, b)
    length = a.sig.shape[dim]
    if length <= MAX_DOT_LENGTH:
        return quire_finalize(quire_partial(a, b, dim=dim))
    a, b = _move_last(a, dim), _move_last(b, dim)
    state = None
    for ac, bc in _iter_chunks(a, b, length):
        part = quire_partial(ac, bc, dim=-1)
        state = part if state is None else quire_combine(state, part)
    return quire_finalize(state)


# ---------------------------------------------------------------------------
# Exact 512-bit quire (Posit Standard 2022)
# ---------------------------------------------------------------------------
# For posit<32,2>, product bit weights span 2^(exp-62), exp in [-240, 240];
# a fixed-point register over [2^-302, 2^178) plus 32 carry bits is the
# standard's 512-bit quire.

_QLIMB = 16                      # 512 bits
_QBIAS = 302                     # shift = exp + _QBIAS in [0, 480]


def _quire_place(p: u64.U64, exp):
    """The Q2.62 product at absolute bit offset ``exp + _QBIAS``, as 16
    limbs (MSB-first)."""
    s = exp + _QBIAS
    limbs = []
    for j in range(_QLIMB - 1, -1, -1):
        d = 32 * j - s
        right = torch.where((d >= 0) & (d < 64), u64.shr(p, d.clamp(0, 63)).lo, 0)
        left = torch.where((d < 0) & (d > -64), u64.shl(p, (-d).clamp(0, 63)).lo, 0)
        limbs.append(right | left)
    return limbs


def _quire_exact_partial(a: PIR, b: PIR, dim: int):
    """One tile into the exact quire -> (limbs MSB-first, any_nar)."""
    if a.sig.shape[dim] > MAX_DOT_LENGTH:
        raise ValueError(
            f"_quire_exact_partial tile length {a.sig.shape[dim]} exceeds "
            f"MAX_DOT_LENGTH={MAX_DOT_LENGTH}; chunk the reduction")
    pzero = a.is_zero | b.is_zero
    any_nar = (a.is_nar | b.is_nar).any(dim=dim)
    prod = u64.mul_32x32(a.sig, b.sig)
    prod = u64.select(pzero, u64.zeros_like(prod), prod)
    limbs = _quire_place(prod, torch.where(pzero, 0, a.exp + b.exp))
    limbs = [torch.where(pzero, 0, x) for x in limbs]
    neg = ((a.sign ^ b.sign) == 1) & ~pzero
    limbs = [torch.where(neg, n, p) for n, p in zip(_neg_n(limbs), limbs)]
    return _sum_n(limbs, dim), any_nar


def _quire_exact_finalize(acc, any_nar):
    """512-bit quire -> (PIR, sticky)."""
    sign_out = (acc[0] >> 31) & 1
    acc = [torch.where(sign_out == 1, n, p) for n, p in zip(_neg_n(acc), acc)]
    nonzero = acc[0]
    for x in acc[1:]:
        nonzero = nonzero | x
    is_zero = nonzero == 0

    msb = 511 - _clz_n(acc)
    exp_out = msb - (_QBIAS + 62)
    # significand = bits [msb .. msb-31]; sticky = anything below
    sh = msb - 31
    sig = torch.zeros_like(acc[0])
    sticky = torch.zeros_like(acc[0])
    for j in range(_QLIMB):                   # limb j covers bits 32j..+31
        x = acc[_QLIMB - 1 - j]
        d = sh - 32 * j
        hit = srl(x, d) | torch.where((d < 0) & (d > -32), sll(x, -d), 0)
        sig = sig | torch.where((d > -32) & (d < 32), hit, 0)
        below = torch.where(d >= 32, x != 0,
                            torch.where(d > 0, (x & ((sll(1, d) - 1) & M32)) != 0,
                                        False))
        sticky = sticky | below.to(sticky.dtype)

    pir = PIR(sign=torch.where(is_zero, 0, sign_out),
              exp=torch.where(is_zero, 0, exp_out),
              sig=torch.where(is_zero, 0, sig),
              is_zero=is_zero, is_nar=any_nar)
    return pir, sticky


def vpdot_quire(a: PIR, b: PIR, cfg: PositConfig, dim: int = -1):
    """Exact dot product through the 512-bit quire -> (PIR, sticky); any
    length, tiles added exactly (order-independent)."""
    if cfg.nbits > 32 or cfg.es > 2:
        raise ValueError("quire sizing assumes posit<=32, es<=2")
    a, b = _broadcast(a, b)
    length = a.sig.shape[dim]
    if length <= MAX_DOT_LENGTH:
        return _quire_exact_finalize(*_quire_exact_partial(a, b, dim))
    a, b = _move_last(a, dim), _move_last(b, dim)
    acc, nar = None, None
    for ac, bc in _iter_chunks(a, b, length):
        part, pnar = _quire_exact_partial(ac, bc, -1)
        acc = part if acc is None else _add_n(acc, part)
        nar = pnar if nar is None else (nar | pnar)
    return _quire_exact_finalize(acc, nar)
