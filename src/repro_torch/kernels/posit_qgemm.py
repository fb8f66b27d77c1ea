"""pgemm: posit (M, K) x posit (K, N) -> posit (M, N) through the quire (CUDA).

Replaces ``repro/kernels/posit_qgemm.py`` ``posit_qgemm`` (the Pallas
TPU kernel ``_qgemm_kernel``): each output is one quire-lite reduction
over K, in tiles of ``MAX_DOT_LENGTH`` folded in order, rounded once,
so ``pgemm(a, w)[i, j] == dot(a[i], w[:, j])`` bit for bit
(``csrc/posit_qgemm.cu``; the quire code is ``csrc/pvu.cuh``'s, shared
with ``posit_dot.cu``).

Bound on the H100: integer operations per product.  A CTA owns 16 x 64
outputs and one K tile (2 x 2 outputs a thread), operands decoded once
per CTA and pass into shared memory; the K tiles run in parallel and
their states are folded in tile order by a second kernel into the one
rounding (a single-tile K finalizes in the first).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core import posit as P
from repro_torch.core.types import PositConfig, signed_view, zeros

from . import _build

launches = {"posit_qgemm": 0}


def posit_qgemm_plain(a, w, cfg: PositConfig,
                      max_entries: int = 1 << 22) -> torch.Tensor:
    """Plain PyTorch version: ``core.posit.vpdot`` over the (m, K, N)
    product lattice (as ``repro/kernels/ref.py::pgemm_ref``), in chunks
    of rows so that a chunk's lattice holds at most ``max_entries``."""
    m, k = a.shape
    n = w.shape[1]
    if m == 0 or n == 0 or k == 0:
        return zeros((m, n), cfg.storage_dtype, device=a.device)
    rows = max(1, max_entries // max(k * n, 1))
    wl = w[None]
    parts = [P.vpdot(a[i:i + rows, :, None], wl, cfg, dim=1)
             for i in range(0, m, rows)]
    return torch.cat([signed_view(p) for p in parts]).view(cfg.storage_dtype)


def _prepare(a, w, cfg):
    """Checks, output and workspace of one call; returns ``(call, out)``
    with ``call()`` the kernel's C call (returns its CUDA error code), or
    None when the product is empty."""
    _build.check_cfg(cfg, "posit_qgemm")
    for t in (a, w):
        if t.device.type != "cuda" or t.device != a.device \
                or t.dtype != cfg.storage_dtype or not t.is_contiguous():
            raise ValueError(f"posit_qgemm needs contiguous {cfg.storage_dtype} "
                             f"CUDA tensors on one device, got {t.dtype} on "
                             f"{t.device} (contiguous={t.is_contiguous()})")
    m, k = a.shape
    n = w.shape[1]
    if m == 0 or n == 0 or k == 0:
        return None, zeros((m, n), cfg.storage_dtype, device=a.device)
    out = torch.empty((m, n), dtype=cfg.storage_dtype, device=a.device)
    lib = _build.load("posit_qgemm")
    nbytes = lib.posit_qgemm_workspace_bytes(m, k, n)
    ws = torch.empty((nbytes,), dtype=torch.uint8, device=a.device)
    args = (cfg.nbits, cfg.es, a.data_ptr(), w.data_ptr(), out.data_ptr(),
            ws.data_ptr(), nbytes, m, k, n,
            torch.cuda.current_stream(a.device).cuda_stream)
    fn = lib.posit_qgemm
    return (lambda: fn(*args)), out


def posit_qgemm(a: torch.Tensor, w: torch.Tensor,
                cfg: PositConfig) -> torch.Tensor:
    """a: posit (M, K); w: posit (K, N) -> posit (M, N), quire-exact."""
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"pgemm contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(w.shape)}")
    if a.device.type == "cpu" and w.device.type == "cpu":
        return posit_qgemm_plain(a, w, cfg)
    call, out = _prepare(a, w, cfg)
    if call is not None:
        _build.check(call(), "posit_qgemm")
        launches["posit_qgemm"] += 1
    return out


def posit_qgemm_call(a, w, cfg: PositConfig):
    """For timing the kernel alone: ``(call, out)``, where ``call()``
    launches the kernel (and the fold) once more on the same output and
    workspace and returns the CUDA error code.  Not counted in
    ``launches``; CUDA tensors of a non-empty product only."""
    return _prepare(a, w, cfg)
