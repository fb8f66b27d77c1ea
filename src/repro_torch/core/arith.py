"""PVU arithmetic on the PIR domain (add/sub/mul/div) on torch tensors.

The reference's datapath (``repro/core/arith.py``, the paper's
§IV-B/C/D), line for line on 32-bit lanes held in int64 tensors:

* add/sub -- align the smaller operand to the larger exponent with a
  sticky, combine magnitudes in 64 bits (31 guard bits), renormalize;
  exactly rounded at ``align_width=63``.
* mul -- the exact 32x32 significand product, one rounding.
* div -- ``nr3``: the paper's 3-iteration Newton-Raphson reciprocal in
  truncating fixed point (its residual error is the paper's ~95.8 %
  exact-match rate), then the multiplier; ``exact``: a 33-step
  restoring division, exactly rounded.

Every op returns ``(PIR, sticky)``; the single rounding happens at
``pir.encode_pir``.  The CUDA kernels (``csrc/pvu.cuh``) run the same
arithmetic per element and must agree with it bit for bit.
"""
from __future__ import annotations

import torch

from . import u64
from .bits import M32
from .pir import PIR
from .types import PositConfig

_EXP_SENTINEL = -(1 << 28)  # stands in for -inf when an operand is zero


def negate(p: PIR) -> PIR:
    """Posit negation is exact: flip the sign (zero/NaR unchanged)."""
    return p._replace(sign=torch.where(p.is_zero | p.is_nar, p.sign,
                                       p.sign ^ 1))


def _sig_to_u64(sig) -> u64.U64:
    """Q1.31 sig -> u64 with the hidden 1 at bit 62 (31 guard bits)."""
    return u64.U64(sig >> 1, (sig << 31) & M32)


def _normalize_u64(mag: u64.U64, exp, sticky):
    """Renormalize so the MSB sits at bit 62; returns (sig, exp, sticky).
    Handles the carry-out (MSB at 63) and cancellation (MSB below 62)."""
    lz = u64.clz64(mag)                       # 0..64
    left = u64.shl(mag, (lz - 1).clamp(min=0))
    right, st_r = u64.shr_sticky(mag, torch.ones_like(lz))
    out = u64.select(lz == 0, right, left)
    sticky = sticky | torch.where(lz == 0, st_r, 0)
    exp_out = exp + 1 - lz
    sig = ((out.hi << 1) & M32) | (out.lo >> 31)
    sticky = sticky | ((out.lo & 0x7FFFFFFF) != 0).to(sig.dtype)
    return sig, exp_out, sticky


def vpadd(a: PIR, b: PIR, cfg: PositConfig):
    """Vector posit add on PIRs -> (PIR, sticky)."""
    ea = torch.where(a.is_zero, _EXP_SENTINEL, a.exp)
    eb = torch.where(b.is_zero, _EXP_SENTINEL, b.exp)
    exp_t = torch.maximum(ea, eb)

    d_a = (exp_t - ea).clamp(0, 63)
    d_b = (exp_t - eb).clamp(0, 63)
    m_a, st_a = u64.shr_sticky(_sig_to_u64(a.sig), d_a)
    m_b, st_b = u64.shr_sticky(_sig_to_u64(b.sig), d_b)
    # a narrower hardware aligner flushes operands shifted past it (the
    # value survives only through sticky)
    if cfg.align_width < 63:
        over_a = d_a > cfg.align_width
        over_b = d_b > cfg.align_width
        st_a = torch.where(over_a & (a.sig != 0), 1, st_a)
        st_b = torch.where(over_b & (b.sig != 0), 1, st_b)
        m_a = u64.select(over_a, u64.zeros_like(m_a), m_a)
        m_b = u64.select(over_b, u64.zeros_like(m_b), m_b)

    same = a.sign == b.sign
    a_ge_b = u64.ge(m_a, m_b)
    ssum = u64.add(m_a, m_b)
    diff = u64.select(a_ge_b, u64.sub(m_a, m_b), u64.sub(m_b, m_a))
    st = st_a | st_b  # at most one is nonzero (only the smaller shifts)
    # subtracting a truncated tail: true = diff - delta, delta in (0, 1)
    # ulp, so the floor is diff - 1 with sticky set
    diff = u64.select((~same) & (st == 1),
                      u64.sub(diff, u64.from32(torch.ones_like(st))), diff)
    mag = u64.select(same, ssum, diff)
    sign = torch.where(same, a.sign, torch.where(a_ge_b, a.sign, b.sign))

    sig, exp, sticky = _normalize_u64(mag, exp_t, st)

    out_zero = u64.is_zero(mag) & (st == 0)
    sign = torch.where(out_zero, 0, sign)

    # a zero operand passes the other through untouched
    sign = torch.where(a.is_zero, b.sign, torch.where(b.is_zero, a.sign, sign))
    exp = torch.where(a.is_zero, b.exp, torch.where(b.is_zero, a.exp, exp))
    sig = torch.where(a.is_zero, b.sig, torch.where(b.is_zero, a.sig, sig))
    sticky = torch.where(a.is_zero | b.is_zero, 0, sticky)
    is_zero = torch.where(a.is_zero, b.is_zero,
                          torch.where(b.is_zero, a.is_zero, out_zero))
    return PIR(sign, exp, sig, is_zero, a.is_nar | b.is_nar), sticky


def vpsub(a: PIR, b: PIR, cfg: PositConfig):
    return vpadd(a, negate(b), cfg)


def vpmul(a: PIR, b: PIR, cfg: PositConfig):
    """Vector posit multiply on PIRs -> (PIR, sticky)."""
    del cfg
    sign = a.sign ^ b.sign
    prod = u64.mul_32x32(a.sig, b.sig)        # Q2.62, value in [1, 4)
    hi_set = (prod.hi >> 31) != 0             # bit 63: value >= 2
    sig = torch.where(hi_set, prod.hi,
                      ((prod.hi << 1) & M32) | (prod.lo >> 31))
    sticky = torch.where(hi_set, prod.lo != 0,
                         (prod.lo & 0x7FFFFFFF) != 0).to(sig.dtype)
    exp = a.exp + b.exp + hi_set.to(a.exp.dtype)

    is_zero = a.is_zero | b.is_zero
    is_nar = a.is_nar | b.is_nar
    sign = torch.where(is_zero | is_nar, 0, sign)
    sig = torch.where(is_zero, 0, sig)
    sticky = torch.where(is_zero, 0, sticky)
    return PIR(sign, exp, sig, is_zero, is_nar), sticky


# Newton-Raphson seed x0 = 48/17 - 32/17 * c for c in [0.5, 1), in Q1.31.
_K1_Q31 = int(round(48 / 17 * (1 << 31)))   # needs 33 bits: kept as u64
_K2_Q31 = int(round(32 / 17 * (1 << 31)))   # fits 32 bits


def _nr_reciprocal(sig_b, iters: int = 3):
    """Approximate 2^63 / sig_b in Q1.31, in truncating fixed point (the
    hardware-faithful path: its residual error is the paper's 95.84 %)."""
    term = u64.mul_32x32(torch.full_like(sig_b, _K2_Q31), sig_b).hi
    k1 = u64.make(torch.full_like(sig_b, _K1_Q31 >> 32),
                  torch.full_like(sig_b, _K1_Q31 & M32))
    x = u64.sub(k1, u64.from32(term)).lo              # x0 in Q1.31
    for _ in range(iters):
        t = u64.mul_32x32(sig_b, x)                   # c*x, Q2.62-ish
        tm = u64.neg(t)                               # (2 - c*x) at 2^63
        hi = u64.mul_64x32_hi64(tm, x)                # (x*tm) >> 32
        x = ((hi.hi << 1) & M32) | (hi.lo >> 31)      # >> 63 overall
    return x


def _div_exact_sig(sig_a, sig_b):
    """Exactly rounded significand quotient by restoring long division:
    33 quotient bits and the remainder -> (sig, exp_adjust, sticky)."""
    den = u64.from32(sig_b)
    ge0 = sig_a >= sig_b
    q = u64.from32(ge0.to(sig_a.dtype))
    rem = u64.from32(torch.where(ge0, sig_a - sig_b, sig_a))
    one = torch.ones_like(sig_a)
    for _ in range(33):
        rem = u64.shl(rem, one)
        geq = u64.ge(rem, den)
        rem = u64.select(geq, u64.sub(rem, den), rem)
        q = u64.add(u64.shl(q, one), u64.from32(geq.to(sig_a.dtype)))
    sticky = (~u64.is_zero(rem)).to(sig_a.dtype)
    # q in (2^32, 2^34), value q * 2^-33: bit 33 set <=> ratio >= 1
    bit33 = (q.hi >> 1) & 1
    sig_hi, st_hi = u64.shr_sticky(q, 2 * one)
    sig_lo, st_lo = u64.shr_sticky(q, one)
    sig = torch.where(bit33 == 1, sig_hi.lo, sig_lo.lo)
    sticky = sticky | torch.where(bit33 == 1, st_hi, st_lo)
    exp_adj = torch.where(bit33 == 1, 0, -1)
    return sig, exp_adj, sticky


def vpdiv(a: PIR, b: PIR, cfg: PositConfig, mode: str = "nr3"):
    """Vector posit divide -> (PIR, sticky).  ``mode='nr3'`` is the
    paper's Newton-Raphson divider, ``'exact'`` the restoring one."""
    del cfg
    sign = a.sign ^ b.sign
    exp = a.exp - b.exp
    if mode == "exact":
        sig, exp_adj, sticky = _div_exact_sig(a.sig, b.sig)
        exp = exp + exp_adj
    elif mode == "nr3":
        x = _nr_reciprocal(b.sig, iters=3)
        prod = u64.mul_32x32(a.sig, x)        # ~2*a/b in Q2.62
        # truncation can land the product just below 1.0: the general
        # renormalizer handles an MSB at 63, 62 or below
        sig, exp, sticky = _normalize_u64(prod, exp, torch.zeros_like(x))
        exp = exp - 1                          # fold the factor of 2
        # dividing by a power of two is exact (and b == 1 returns a)
        pow2 = b.sig == 0x80000000
        sig = torch.where(pow2, a.sig, sig)
        sticky = torch.where(pow2, 0, sticky)
        exp = torch.where(pow2, a.exp - b.exp, exp)
    else:
        raise ValueError(f"unknown div mode {mode!r}")

    is_nar = a.is_nar | b.is_nar | b.is_zero  # x/0 = NaR
    is_zero = a.is_zero & ~b.is_zero
    sign = torch.where(is_zero | is_nar, 0, sign)
    sig = torch.where(is_zero, 0, sig)
    sticky = torch.where(is_zero, 0, sticky)
    return PIR(sign, exp, sig, is_zero, is_nar), sticky
