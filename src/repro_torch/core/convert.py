"""Exact float32 <-> posit conversion on torch tensors.

The plain (tensor-op) form of the codec: the CUDA kernels in
``csrc/posit.cuh`` run the same arithmetic per element and must agree
with it bit for bit.  Both directions round to nearest even;
f32 NaN/Inf -> NaR, NaR -> f32 NaN, +/-0 -> posit 0 -> f32 +0.
"""
from __future__ import annotations

import torch

from .bits import M32, clz32, sll, srl
from .pir import PIR, decode, encode
from .types import PositConfig, signed_view, to_storage


def _f32_bits(x) -> torch.Tensor:
    x = torch.as_tensor(x).to(torch.float32).contiguous()
    return x.view(torch.int32).to(torch.int64) & M32


def _bits_f32(b) -> torch.Tensor:
    b = torch.where(b >= 1 << 31, b - (1 << 32), b)
    return b.to(torch.int32).view(torch.float32)


def f32_to_posit(x, cfg: PositConfig) -> torch.Tensor:
    """float32 tensor -> posit patterns in ``cfg.storage_dtype``."""
    bits = _f32_bits(x)
    sign = bits >> 31
    exp8 = (bits >> 23) & 0xFF
    man = bits & 0x7FFFFF

    is_nar = exp8 == 255                    # inf or nan
    is_zero = (exp8 == 0) & (man == 0)

    exp_n = exp8 - 127
    sig_n = 0x80000000 | (man << 8)
    # subnormals: value = man * 2^-149, normalized through clz
    sh = clz32(man)
    sig_s = sll(man, sh)
    exp_s = -118 - sh

    subnormal = (exp8 == 0) & (man != 0)
    sig = torch.where(subnormal, sig_s, sig_n)
    exp = torch.where(subnormal, exp_s, exp_n)

    p = encode(sign, exp, sig, torch.zeros_like(sign), is_zero, is_nar, cfg)
    return to_storage(p, cfg.storage_dtype)


def posit_to_f32(p, cfg: PositConfig) -> torch.Tensor:
    """Posit patterns -> float32, exactly rounded (RNE)."""
    # a signed view sign-extends; decode keeps the low nbits
    pir: PIR = decode(signed_view(torch.as_tensor(p)).to(torch.int64), cfg)
    sign, exp, sig = pir.sign, pir.exp, pir.sig

    # the mantissa field is sig >> r, rounded at bit r-1; r = 8 emits a
    # normal, and for exp < -126 (an f32 subnormal) r grows so the hidden
    # bit lands inside the field
    is_sub = exp < -126
    t = (-(exp + 118)).clamp(9, 40)
    r = torch.where(is_sub, t, 8)

    pre = srl(sig, r)
    round_bit = srl(sig, r - 1) & 1
    mask = (sll(1, r - 1) - 1) & M32        # r-1 >= 32 wraps to all ones
    sticky = ((sig & mask) != 0).to(sig.dtype)

    man = pre & 0x7FFFFF
    man_r = man + (round_bit & (sticky | (man & 1)))
    carry = man_r >> 23
    man_f = man_r & 0x7FFFFF

    biased = torch.where(is_sub, -127, exp) + carry + 127
    overflow = biased > 254
    biased = biased.clamp(0, 254)

    out = (sign << 31) | (biased << 23) | man_f
    out = torch.where(overflow, (sign << 31) | 0x7F800000, out)
    out = torch.where(pir.is_zero, sign << 31, out)
    out = torch.where(pir.is_nar, 0x7FC00000, out)
    return _bits_f32(out)


def quant_dequant(x, cfg: PositConfig) -> torch.Tensor:
    """Round trip f32 -> posit -> f32: the straight-through quantizer."""
    return posit_to_f32(f32_to_posit(x, cfg), cfg)
