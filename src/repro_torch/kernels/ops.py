"""The PVU library boundary: shape-polymorphic wrappers over the kernels.

What the rest of the port calls (``repro/kernels/ops.py``'s surface):
any rank, operands that broadcast, empty dimensions (an empty quire is
posit zero), each call one kernel launch on CUDA tensors or the plain
version on CPU tensors.  Inputs are posit patterns in
``cfg.storage_dtype`` (other integer dtypes holding the pattern bits are
converted) or f32 where the op takes floats.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.types import PositConfig, signed_view, to_storage, zeros
from . import posit_codec, posit_dot, posit_ew, posit_gemm, posit_qgemm
# the paged-decode attention entries are cache-layout specific, not
# shape-polymorphic: re-exported as they are, one public kernel surface
from .posit_paged_attn import (paged_decode_attention,        # noqa: F401
                               paged_decode_attention_mla,    # noqa: F401
                               paged_decode_kv_bytes)         # noqa: F401


def _patterns(x, cfg: PositConfig) -> torch.Tensor:
    """``x`` as a pattern tensor in ``cfg.storage_dtype``."""
    x = torch.as_tensor(x)
    if x.dtype == cfg.storage_dtype:
        return x
    return to_storage(signed_view(x).to(torch.int64) & cfg.mask,
                      cfg.storage_dtype)


def _contiguous(x: torch.Tensor, shape=None) -> torch.Tensor:
    """A pattern tensor (any dtype) contiguous in memory, broadcast to
    ``shape`` first when given."""
    s = signed_view(x)
    return (s if shape is None else s.expand(shape)).contiguous().view(x.dtype)


def quantize(x, cfg: PositConfig) -> torch.Tensor:
    """f32 tensor (any rank) -> posit patterns, via the codec kernel."""
    x = torch.as_tensor(x).to(torch.float32).contiguous()
    return posit_codec.quantize(x, cfg)


def dequantize(p, cfg: PositConfig) -> torch.Tensor:
    """Posit patterns (any rank) -> f32, via the codec kernel."""
    return posit_codec.dequantize(_contiguous(_patterns(p, cfg)), cfg)


def gemm(a, w_patterns, cfg: PositConfig) -> torch.Tensor:
    """f32 (..., K) @ posit (K, N) -> f32 (..., N), weights decoded in
    the kernel."""
    a = torch.as_tensor(a).to(torch.float32)
    w = _contiguous(_patterns(w_patterns, cfg))
    if w.dim() != 2:
        raise ValueError(f"gemm weights must be (K, N), got {tuple(w.shape)}")
    k, n = w.shape
    if a.dim() == 0 or a.shape[-1] != k:
        raise ValueError(f"gemm contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(w.shape)}")
    a2 = a.reshape(math.prod(a.shape[:-1]), k).contiguous()
    return posit_gemm.posit_gemm(a2, w, cfg).reshape(a.shape[:-1] + (n,))


def dot(a_patterns, b_patterns, cfg: PositConfig) -> torch.Tensor:
    """Bit-exact PVU dot product over the trailing axis, any rank.

    Operands broadcast (a rank-1 vector against a batched stack); the
    result drops the contracted axis: (L,) -> scalar, (R, L) -> (R,),
    (B, R, L) -> (B, R).  Any reduction length, one rounding.
    """
    a, b = _patterns(a_patterns, cfg), _patterns(b_patterns, cfg)
    if a.dim() == 0 or b.dim() == 0:
        raise ValueError("dot needs rank >= 1 operands (a reduction axis)")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    r = math.prod(shape[:-1])
    if r == 0 or shape[-1] == 0:            # empty quire -> posit zero
        return zeros(shape[:-1], cfg.storage_dtype, device=a.device)
    a2 = _contiguous(a, shape).reshape(r, shape[-1])
    b2 = _contiguous(b, shape).reshape(r, shape[-1])
    return posit_dot.vpdot_rows(a2, b2, cfg).reshape(shape[:-1])


def dot_rows(a_patterns, b_patterns, cfg: PositConfig) -> torch.Tensor:
    """Per-row PVU dot product (..., L) -> (...); the reference's
    historic name for :func:`dot`."""
    return dot(a_patterns, b_patterns, cfg)


def pgemm(a_patterns, w_patterns, cfg: PositConfig) -> torch.Tensor:
    """Bit-exact posit matmul: posit (..., K) @ posit (K, N) -> posit
    (..., N), one quire rounding per output."""
    a, w = _patterns(a_patterns, cfg), _patterns(w_patterns, cfg)
    if w.dim() != 2:
        raise ValueError(f"pgemm weights must be (K, N), got {tuple(w.shape)}")
    if a.dim() == 0:
        raise ValueError("pgemm needs rank >= 1 activations")
    k, n = w.shape
    if a.shape[-1] != k:
        raise ValueError(f"pgemm contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(w.shape)}")
    a2 = _contiguous(a).reshape(math.prod(a.shape[:-1]), k)
    out = posit_qgemm.posit_qgemm(a2, _contiguous(w), cfg)
    return out.reshape(a.shape[:-1] + (n,))


# ---------------------------------------------------------------------------
# Fused elementwise PVU ops (posit patterns in -> posit patterns out)
# ---------------------------------------------------------------------------

def _elementwise(a, b, cfg: PositConfig, op: str, div_mode: str = "nr3"):
    return posit_ew.elementwise(_patterns(a, cfg), _patterns(b, cfg), cfg,
                                op, div_mode)


def vadd(a, b, cfg: PositConfig) -> torch.Tensor:
    """Fused posit add: patterns (any rank, broadcastable) -> patterns."""
    return _elementwise(a, b, cfg, "add")


def vsub(a, b, cfg: PositConfig) -> torch.Tensor:
    """Fused posit subtract on patterns."""
    return _elementwise(a, b, cfg, "sub")


def vmul(a, b, cfg: PositConfig) -> torch.Tensor:
    """Fused posit multiply on patterns."""
    return _elementwise(a, b, cfg, "mul")


def vdiv(a, b, cfg: PositConfig, mode: str = "nr3") -> torch.Tensor:
    """Fused posit divide on patterns: ``mode='nr3'`` is the paper's
    Newton-Raphson divider, ``'exact'`` the exactly rounded one."""
    return _elementwise(a, b, cfg, "div", div_mode=mode)
