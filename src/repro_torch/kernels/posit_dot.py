"""Row-wise posit dot product through the quire-lite (CUDA).

Replaces ``repro/kernels/posit_dot.py`` ``vpdot_rows`` (the Pallas TPU
kernel ``_vpdot_kernel``): (R, L) x (R, L) -> (R,) patterns, L
unbounded, in tiles of ``MAX_DOT_LENGTH`` whose quire states fold in
order and round once (``csrc/posit_dot.cu``, the quire of
``csrc/pvu.cuh``).

Bound on the H100: integer operations per product.  One warp per row:
a warp-wide max of the tile's product exponents, then the aligned
128-bit sum; a loop over the tiles takes the place of the TPU's
sequential grid dimension.

On a CPU tensor the wrapper runs the plain version (``core.posit.vpdot``,
which tiles the same way); on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.core import posit as P
from repro_torch.core.types import PositConfig, signed_view, zeros

from . import _build

launches = {"posit_dot": 0}


def vpdot_rows_plain(a, b, cfg: PositConfig,
                     max_entries: int = 1 << 22) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``core.posit.vpdot`` on
    chunks of rows of at most ``max_entries`` products each."""
    rows = max(1, max_entries // max(a.shape[-1], 1))
    parts = [P.vpdot(a[i:i + rows], b[i:i + rows], cfg, dim=-1)
             for i in range(0, a.shape[0], rows)]
    return torch.cat([signed_view(p) for p in parts]).view(cfg.storage_dtype)


def vpdot_rows(a: torch.Tensor, b: torch.Tensor,
               cfg: PositConfig) -> torch.Tensor:
    """(R, L) x (R, L) pattern tensors -> (R,) patterns, one rounding per
    row; an empty row (L == 0) is posit zero."""
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"vpdot_rows needs two (R, L) operands of one "
                         f"shape, got {tuple(a.shape)} and {tuple(b.shape)}")
    r, length = a.shape
    if a.device.type == "cpu" and b.device.type == "cpu":
        if r == 0 or length == 0:
            return zeros((r,), cfg.storage_dtype)
        return vpdot_rows_plain(a, b, cfg)
    _build.check_cfg(cfg, "posit_dot")
    for t in (a, b):
        if t.device.type != "cuda" or t.dtype != cfg.storage_dtype \
                or not t.is_contiguous():
            raise ValueError(f"posit_dot needs contiguous {cfg.storage_dtype} "
                             f"CUDA tensors, got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    if r == 0 or length == 0:
        return zeros((r,), cfg.storage_dtype, device=a.device)
    out = torch.empty((r,), dtype=cfg.storage_dtype, device=a.device)
    lib = _build.load("posit_dot")
    rc = lib.posit_dot_rows(cfg.nbits, cfg.es, a.data_ptr(), b.data_ptr(),
                            out.data_ptr(), r, length,
                            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "posit_dot")
    launches["posit_dot"] += 1
    return out
