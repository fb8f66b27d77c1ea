"""Row-wise posit dot product through the quire-lite (CUDA).

Replaces ``repro/kernels/posit_dot.py`` ``vpdot_rows`` (the Pallas TPU
kernel ``_vpdot_kernel``): (R, L) x (R, L) -> (R,) patterns, L
unbounded, in tiles of ``MAX_DOT_LENGTH`` whose quire states fold in
order and round once (``csrc/posit_dot.cu``, the quire of
``csrc/pvu.cuh``, the placement ``posit_qgemm.cu`` shares).

Bound on the H100: bytes at the conv's short rows, its operations at
half of that at the card's issue rate.  A CTA stages its rows (or one row's quire tile, double-
buffered) in shared memory with 16-byte ``cp.async``; ``group_for``
gives each row 8, 16 or 32 lanes when it fits 10 products a lane
(decoded once, kept in registers between the max and the placing pass)
and a whole CTA of 256 lanes otherwise.

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


def group_for(length: int) -> int:
    """Lanes a row in ``csrc/posit_dot.cu``: 8, 16 or 32 for a row that
    fits 10 products a lane, a whole CTA of 256 otherwise."""
    for g in (8, 16, 32):
        if length <= 10 * g:
            return g
    return 256


def _prepare(a, b, cfg, group=None):
    """Checks and output of one call; returns ``(call, out)`` with
    ``call()`` the kernel's C call (returns its CUDA error code), or None
    when there is nothing to reduce.  ``group`` overrides ``group_for``."""
    r, length = a.shape
    _build.check_cfg(cfg, "posit_dot")
    for t in (a, b):
        if t.device.type != "cuda" or t.device != a.device \
                or t.dtype != cfg.storage_dtype or not t.is_contiguous():
            raise ValueError(f"posit_dot needs contiguous {cfg.storage_dtype} "
                             f"CUDA tensors on one device, got {t.dtype} on "
                             f"{t.device} (contiguous={t.is_contiguous()})")
    if r == 0 or length == 0:
        return None, zeros((r,), cfg.storage_dtype, device=a.device)
    out = torch.empty((r,), dtype=cfg.storage_dtype, device=a.device)
    lib = _build.load("posit_dot")
    args = (cfg.nbits, cfg.es, a.data_ptr(), b.data_ptr(), out.data_ptr(), r,
            length, group_for(length) if group is None else group,
            torch.cuda.current_stream(a.device).cuda_stream)
    fn = lib.posit_dot_rows
    return (lambda: fn(*args)), out


def vpdot_rows(a: torch.Tensor, b: torch.Tensor,
               cfg: PositConfig) -> torch.Tensor:
    """(R, L) x (R, L) pattern tensors -> (R,) patterns, one rounding per
    row; an empty row (L == 0) is posit zero."""
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"vpdot_rows needs two (R, L) operands of one "
                         f"shape, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        r, length = a.shape
        if r == 0 or length == 0:
            return zeros((r,), cfg.storage_dtype)
        return vpdot_rows_plain(a, b, cfg)
    call, out = _prepare(a, b, cfg)
    if call is not None:
        _build.check(call(), "posit_dot")
        launches["posit_dot"] += 1
    return out


def vpdot_rows_call(a, b, cfg: PositConfig, group=None):
    """For timing the kernel alone: ``(call, out)``, where ``call()``
    launches the kernel once more on the same operands and output and
    returns the CUDA error code.  Not counted in ``launches``; CUDA
    tensors of a non-empty product only."""
    return _prepare(a, b, cfg, group)
