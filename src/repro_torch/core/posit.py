"""Public PVU vector API -- the software surface of the paper's RVV ISA.

The paper's five custom instructions (Table II), ``vpadd / vpsub /
vpmul / vpdiv / vpdot``, on posit pattern tensors (uint8/uint16/uint32
by ``cfg.nbits``; any integer dtype holding the pattern bits is read).
Each call is decode -> PIR compute -> one rounding at encode, as one
pass through the hardware pipeline.  These are the plain tensor forms
that the CUDA kernels (``kernels/posit_ew.py``, ``posit_dot.py``,
``posit_qgemm.py``) are held to; ``kernels.ops`` is the dispatching
library boundary.
"""
from __future__ import annotations

import torch

from . import arith, dot as dot_mod
from .convert import f32_to_posit, posit_to_f32, quant_dequant  # noqa: F401
from .pir import decode, encode_pir
from .types import POSIT8, POSIT16, POSIT32, PositConfig, signed_view, \
    to_storage  # noqa: F401

__all__ = [
    "vpadd", "vpsub", "vpmul", "vpdiv", "vpdot", "vpneg", "posit_matmul",
    "f32_to_posit", "posit_to_f32", "quant_dequant",
    "PositConfig", "POSIT8", "POSIT16", "POSIT32",
]


def _u(p) -> torch.Tensor:
    """Pattern tensor -> int64 lanes (a signed view sign-extends; decode
    keeps the low nbits)."""
    return signed_view(torch.as_tensor(p)).to(torch.int64)


def _pack(p, cfg: PositConfig) -> torch.Tensor:
    return to_storage(p, cfg.storage_dtype)


def _binary(op, a, b, cfg, **kw):
    pir, sticky = op(decode(_u(a), cfg), decode(_u(b), cfg), cfg, **kw)
    return _pack(encode_pir(pir, cfg, sticky), cfg)


def vpadd(a, b, cfg: PositConfig = POSIT32):
    return _binary(arith.vpadd, a, b, cfg)


def vpsub(a, b, cfg: PositConfig = POSIT32):
    return _binary(arith.vpsub, a, b, cfg)


def vpmul(a, b, cfg: PositConfig = POSIT32):
    return _binary(arith.vpmul, a, b, cfg)


def vpdiv(a, b, cfg: PositConfig = POSIT32, mode: str = "nr3"):
    """``mode='nr3'``: the paper's Newton-Raphson divider; ``'exact'``:
    the exactly rounded restoring divider."""
    return _binary(arith.vpdiv, a, b, cfg, mode=mode)


def vpdot(a, b, cfg: PositConfig = POSIT32, dim: int = -1,
          mode: str = "quire_lite"):
    """Dot product along ``dim`` with one final rounding (§IV-E).

    ``mode='quire_lite'``: the paper's 128-bit aligned accumulator;
    ``'quire'``: the Posit Standard's exact 512-bit quire.
    """
    da, db = decode(_u(a), cfg), decode(_u(b), cfg)
    if mode == "quire":
        pir, sticky = dot_mod.vpdot_quire(da, db, cfg, dim=dim)
    else:
        pir, sticky = dot_mod.vpdot(da, db, cfg, dim=dim)
    return _pack(encode_pir(pir, cfg, sticky), cfg)


def vpneg(a, cfg: PositConfig = POSIT32):
    """Exact negation (two's complement of the pattern)."""
    x = _u(a) & cfg.mask
    keep = (x == 0) | (x == cfg.nar_pattern)
    return _pack(torch.where(keep, x, (~x + 1) & cfg.mask), cfg)


def posit_matmul(a_f32, w_patterns, cfg: PositConfig = POSIT16):
    """Posit-weight matmul: decode ``w`` to f32, then an f32 matmul."""
    return a_f32.to(torch.float32) @ posit_to_f32(w_patterns, cfg)
