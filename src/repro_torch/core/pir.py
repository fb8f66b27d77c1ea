"""Posit <-> PIR (Posit Intermediate Representation) codecs.

The paper's decode pipeline (sign, two's-complement magnitude, LZC over
the regime, exponent field, fraction with the hidden bit) and its
inverse (split the scale into regime and exponent, assemble a 64-bit
stream, round to nearest even on the pattern, saturate, apply the sign).

PIR conventions (all int64 tensors, 32-bit lanes as in ``core/bits.py``):
  sign    {0, 1};  exp  combined scale ``r * 2^es + e``;
  sig     Q1.31 significand, bit 31 the hidden 1 (0 only for zero);
  sticky  {0, 1}, set when the value has bits below sig's LSB.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import u64
from .bits import M32, clz32, i64, sll, u32
from .types import PositConfig


class PIR(NamedTuple):
    sign: torch.Tensor
    exp: torch.Tensor
    sig: torch.Tensor
    is_zero: torch.Tensor
    is_nar: torch.Tensor


def decode(p, cfg: PositConfig) -> PIR:
    """Posit patterns (any integer dtype) -> PIR."""
    n, es = cfg.nbits, cfg.es
    x = u32(p) & cfg.mask
    is_zero = x == 0
    is_nar = x == cfg.nar_pattern

    sign = (x >> (n - 1)) & 1
    ax = torch.where(sign == 1, (~x + 1) & cfg.mask, x)
    y = (ax << (32 - n)) & M32              # sign bit at bit 31

    r0 = (y >> 30) & 1
    t = (torch.where(r0 == 1, ~y, y) & 0x7FFFFFFF) << 1
    k = torch.clamp(clz32(t), max=n - 1)    # regime run length
    r = torch.where(r0 == 1, k - 1, -k)

    body = sll(y, k + 2)                    # exponent now at the top
    e = body >> (32 - es) if es > 0 else torch.zeros_like(body)
    frac_body = sll(body, es)
    sig = 0x80000000 | (frac_body >> 1)
    exp = r * (1 << es) + e

    dead = is_zero | is_nar
    sig = torch.where(dead, 0, sig)
    exp = torch.where(dead, 0, exp)
    sign = torch.where(is_nar, 0, sign)
    return PIR(sign=sign, exp=exp, sig=sig, is_zero=is_zero, is_nar=is_nar)


def encode(sign, exp, sig, sticky, is_zero, is_nar, cfg: PositConfig):
    """PIR -> posit pattern (int64, low ``nbits`` bits) with exact
    round-to-nearest-even; ``sig`` has bit 31 set for nonzero values."""
    n, es = cfg.nbits, cfg.es
    sign, exp, sig, sticky = u32(sign), i64(exp), u32(sig), u32(sticky)

    too_big = exp > cfg.max_scale
    too_small = exp < cfg.min_scale
    expc = exp.clamp(cfg.min_scale, cfg.max_scale)

    r = expc >> es                          # arithmetic: floor division
    e = expc - r * (1 << es)

    reg_pos = r >= 0
    reg_len = torch.where(reg_pos, r + 2, 1 - r)
    # r >= 0: (r+1) ones then a 0 = 2^(r+2) - 2 ; r < 0: (-r) zeros then 1
    v_pos = (sll(2, r + 1) - 2) & M32
    v_pos = torch.where(r + 2 >= 32, 0xFFFFFFFE, v_pos)
    v_reg = torch.where(reg_pos, v_pos, 1)

    stream = u64.shl(u64.from32(v_reg), 64 - reg_len)
    if es > 0:
        stream = u64.bor(stream, u64.shl(u64.from32(e), 64 - reg_len - es))
    frac31 = sig & 0x7FFFFFFF
    fsh = 33 - reg_len - es                 # fraction LSB position
    f_in = u64.select(fsh >= 0,
                      u64.shl(u64.from32(frac31), fsh),
                      u64.shr(u64.from32(frac31), -fsh))
    stream = u64.bor(stream, f_in)
    # fraction bits pushed below the stream are sticky
    drop_mask = (sll(1, -fsh) - 1) & M32
    sticky = sticky | ((fsh < 0) & ((frac31 & drop_mask) != 0)).to(sticky.dtype)
    stream = u64.bor(stream, u64.from32(sticky))

    body = u64.shr(stream, 64 - (n - 1)).lo
    round_bit = u64.bit(stream, 64 - n)
    below = u64.band(stream, u64.sub(u64.shl(u64.from32(1), 64 - n),
                                     u64.from32(1)))
    sticky_rest = ((below.hi | below.lo) != 0).to(body.dtype)
    p = body + (round_bit & (sticky_rest | (body & 1)))

    p = p.clamp(1, cfg.maxpos_pattern)      # never past maxpos, never to 0
    p = torch.where(too_big, cfg.maxpos_pattern, p)
    p = torch.where(too_small, 1, p)
    p = torch.where(sign == 1, (~p + 1) & cfg.mask, p)
    p = torch.where(is_zero, 0, p)
    return torch.where(is_nar, cfg.nar_pattern, p)


def encode_pir(pir: PIR, cfg: PositConfig, sticky=None):
    """``encode`` of a PIR, with the sticky bit an arithmetic op returned
    beside it (no sticky: the PIR is exact)."""
    if sticky is None:
        sticky = torch.zeros_like(pir.sign)
    return encode(pir.sign, pir.exp, pir.sig, sticky, pir.is_zero,
                  pir.is_nar, cfg)
