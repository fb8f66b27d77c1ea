"""f32 (M, K) @ posit (K, N) -> f32 (M, N), weights decoded in the kernel (CUDA).

Replaces ``repro/kernels/posit_gemm.py`` ``posit_gemm`` (the Pallas TPU
kernel ``_gemm_kernel``): the weights stay posit patterns in device
memory, each weight tile is decoded to f32 in shared memory and the
product accumulates in f32 over K (``csrc/posit_gemm.cu``).  fp32 FMAs
on the CUDA cores, no TF32: the numerics of an f32 matmul, with the sums
in another order than the reference's.

Bound on the H100: fp32 operations (2 M N K at 67 TFLOP/s) or the
weight bytes, whichever is larger.  To feed the FMA pipes from registers
the kernel is a register-tiled SGEMM: 128 x 128 output tiles (128 x 64
when N <= 64), an 8 x 8 (8 x 4) micro-tile per thread read with 16-byte
shared-memory loads, weight patterns copied with ``cp.async`` as
vectors and decoded once per tile into shared memory, and the next K
tile's loads in flight during the current tile's FMAs (two
shared-memory stages, one barrier per K tile).  So that the tiles fill the card in whole waves,
:func:`gemm_plan` splits K over the grid when there are too few tiles;
the splits' f32 partials are summed in split order by a second kernel,
so the result does not change from call to call.

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


_BM, _BK = 128, 16


def gemm_plan(m: int, k: int, n: int, sms: int) -> tuple:
    """``(bn, splits)`` for the kernel: the tile width (64 when N <= 64,
    else 128) and the number of K splits.  Each SM works through about
    ceil(tiles * splits / sms) CTAs of ceil(K tiles / splits) steps, and
    every split past the first writes and reads one more (M, N) f32
    partial; take the split count (1 to 8, at least 8 K steps each)
    with the least of that, counted in K steps of one CTA (about 1 us
    for a 128 x 128 tile at the fp32 rate, against 5.5 ns a KiB of
    partial traffic at 3.35 TB/s).  Phi3's MLP down shape (128, 5 120,
    17 920; 140 tiles) on 132 SMs takes several splits; the conv
    (95 048, 147, 64) none."""
    bn = 64 if n <= 64 else 128
    tiles = -(-m // _BM) * -(-n // bn)
    k_steps = max(1, -(-k // _BK))
    step_us = _BM * bn * _BK * 2 / (67e12 / sms) * 1e6
    best = None
    for splits in range(1, 9):
        per = -(-k_steps // splits)
        if splits > 1 and per < 8:
            break
        cost = -(-tiles * splits // sms) * per
        if splits > 1:
            cost += splits * m * n * 8 / 3.35e12 * 1e6 / step_us
        if best is None or cost < best[0]:
            best = (cost, splits)
    return bn, best[1]


def _prepare(a, w, cfg, plan=None):
    """Checks, output and scratch of one call; returns ``(call, out)``
    with ``call()`` the kernel's C call (returns its CUDA error code)."""
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"posit_gemm contraction mismatch: {tuple(a.shape)} "
                         f"@ {tuple(w.shape)}")
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
        return (lambda: 0), out
    bn, splits = plan or gemm_plan(m, k, n, _build.sm_count(a.device))
    part = out if splits == 1 else torch.empty(
        (splits, m, n), dtype=torch.float32, device=a.device)
    lib = _build.load("posit_gemm")
    fn = lib.posit_gemm
    args = (cfg.nbits, cfg.es, a.data_ptr(), w.data_ptr(), out.data_ptr(),
            part.data_ptr(), m, k, n, bn, splits,
            torch.cuda.current_stream(a.device).cuda_stream)
    return (lambda: fn(*args)), out


def posit_gemm(a: torch.Tensor, w: torch.Tensor,
               cfg: PositConfig) -> torch.Tensor:
    """a: f32 (M, K); w: posit patterns (K, N) -> f32 (M, N)."""
    if a.dim() == 2 and w.dim() == 2 and a.shape[1] == w.shape[0] \
            and a.device.type == "cpu" and w.device.type == "cpu":
        return posit_gemm_plain(a, w, cfg)
    call, out = _prepare(a, w, cfg)
    _build.check(call(), "posit_gemm")
    if out.numel():
        launches["posit_gemm"] += 1
    return out


def posit_gemm_call(a, w, cfg: PositConfig, plan=None):
    """For timing the kernel alone: ``(call, out)``, where ``call()``
    launches the kernel (and the split sum) once more on the same
    preallocated output and partials and returns the CUDA error code.
    Not counted in ``launches``; CUDA tensors only.  ``plan`` overrides
    :func:`gemm_plan`'s ``(bn, splits)``."""
    return _prepare(a, w, cfg, plan)
