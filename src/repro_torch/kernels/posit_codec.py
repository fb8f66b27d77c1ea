"""Posit codec kernels: f32 -> posit patterns and back (CUDA).

Replaces ``repro/kernels/posit_codec.py`` ``quantize_2d`` /
``dequantize_2d`` (the Pallas TPU kernels ``_quant_kernel`` and
``_dequant_kernel``).  The kernels (``csrc/posit_codec.cu``) are
elementwise, so these wrappers take a contiguous tensor of any shape.

Bound on the H100: memory -- posit16 moves 6 B per element (4 B f32 in,
2 B pattern out, or the reverse; posit32 8 B, posit8 5 B); the bit
manipulation is a few dozen integer ops per element.  The kernel is one
coalesced grid-stride pass, for the five configs of ``core/types.py``.

On a CPU tensor the wrappers run the plain versions (``core.convert``);
on a CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.core.convert import f32_to_posit, posit_to_f32
from repro_torch.core.types import PositConfig

from . import _build

launches = {"posit_quantize": 0, "posit_dequantize": 0}


def quantize_plain(x: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """Plain PyTorch version of the quantize kernel."""
    return f32_to_posit(x, cfg)


def dequantize_plain(p: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """Plain PyTorch version of the dequantize kernel."""
    return posit_to_f32(p, cfg)


def quantize(x: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """f32 tensor -> posit patterns (``cfg.storage_dtype``), same shape."""
    if x.device.type == "cpu":
        return quantize_plain(x, cfg)
    _build.check_cfg(cfg, "quantize")
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or not x.is_contiguous():
        raise ValueError(f"quantize needs a contiguous float32 CUDA tensor, "
                         f"got {x.dtype} on {x.device} "
                         f"(contiguous={x.is_contiguous()})")
    out = torch.empty(x.shape, dtype=cfg.storage_dtype, device=x.device)
    lib = _build.load("posit_codec")
    rc = lib.posit_quantize(cfg.nbits, cfg.es, x.data_ptr(), out.data_ptr(),
                            x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "posit_quantize")
    launches["posit_quantize"] += 1
    return out


def dequantize(p: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """Posit patterns (``cfg.storage_dtype``) -> f32 tensor, same shape."""
    if p.device.type == "cpu":
        return dequantize_plain(p, cfg)
    _build.check_cfg(cfg, "dequantize")
    if p.device.type != "cuda" or p.dtype != cfg.storage_dtype \
            or not p.is_contiguous():
        raise ValueError(f"dequantize needs a contiguous {cfg.storage_dtype} "
                         f"CUDA tensor, got {p.dtype} on {p.device} "
                         f"(contiguous={p.is_contiguous()})")
    out = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    lib = _build.load("posit_codec")
    rc = lib.posit_dequantize(cfg.nbits, cfg.es, p.data_ptr(), out.data_ptr(),
                              p.numel(), torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(rc, "posit_dequantize")
    launches["posit_dequantize"] += 1
    return out
