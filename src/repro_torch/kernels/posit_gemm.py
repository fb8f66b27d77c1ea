"""f32 (M, K) @ posit (K, N) -> f32 (M, N), weights decoded in the kernel (CUDA).

Replaces ``repro/kernels/posit_gemm.py`` ``posit_gemm`` (the Pallas TPU
kernel ``_gemm_kernel``): the weights stay posit patterns in device
memory, each weight tile is decoded to f32 in shared memory and the
product accumulates in f32 over K (``csrc/posit_gemm.cu``).  fp32 FMAs
on the CUDA cores, no TF32: the numerics of an f32 matmul, with the sums
in another order than the reference's.

Bound on the H100: fp32 operations (2 M N K) or the weight bytes,
whichever is larger.  A shared-memory tiled SGEMM (64 x 64 tiles, 4 x 4
per thread).

On a CPU tensor the wrapper runs the plain version (decode, then an f32
``torch.matmul``); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.convert import posit_to_f32
from repro_torch.core.types import PositConfig

from . import _build

launches = {"posit_gemm": 0}


def posit_gemm_plain(a, w, cfg: PositConfig) -> torch.Tensor:
    """Plain PyTorch version: decode the weights, then an f32 matmul
    (with TF32 as the caller set it; the tests and the smoke turn it
    off)."""
    return a.to(torch.float32) @ posit_to_f32(w, cfg)


def posit_gemm(a: torch.Tensor, w: torch.Tensor,
               cfg: PositConfig) -> torch.Tensor:
    """a: f32 (M, K); w: posit patterns (K, N) -> f32 (M, N)."""
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"posit_gemm contraction mismatch: {tuple(a.shape)} "
                         f"@ {tuple(w.shape)}")
    if a.device.type == "cpu" and w.device.type == "cpu":
        return posit_gemm_plain(a, w, cfg)
    _build.check_cfg(cfg, "posit_gemm")
    if a.device.type != "cuda" or a.dtype != torch.float32 \
            or not a.is_contiguous():
        raise ValueError(f"posit_gemm needs a contiguous float32 CUDA "
                         f"activation, got {a.dtype} on {a.device}")
    if w.device != a.device or w.dtype != cfg.storage_dtype \
            or not w.is_contiguous():
        raise ValueError(f"posit_gemm needs contiguous {cfg.storage_dtype} "
                         f"weights on {a.device}, got {w.dtype} on {w.device}")
    m, k = a.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _build.load("posit_gemm")
    rc = lib.posit_gemm(cfg.nbits, cfg.es, a.data_ptr(), w.data_ptr(),
                        out.data_ptr(), m, k, n,
                        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "posit_gemm")
    launches["posit_gemm"] += 1
    return out
