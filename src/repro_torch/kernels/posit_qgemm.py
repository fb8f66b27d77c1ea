"""pgemm: posit (M, K) x posit (K, N) -> posit (M, N) through the quire (CUDA).

Replaces ``repro/kernels/posit_qgemm.py`` ``posit_qgemm`` (the Pallas
TPU kernel ``_qgemm_kernel``): each output is one quire-lite reduction
over K, in tiles of ``MAX_DOT_LENGTH`` folded in order, rounded once,
so ``pgemm(a, w)[i, j] == dot(a[i], w[:, j])`` bit for bit
(``csrc/posit_qgemm.cu``; the quire code is ``csrc/pvu.cuh``'s, shared
with ``posit_dot.cu``).

Bound on the H100: integer operations per product.  One thread per
output, blocks of 16 x 16 outputs, a loop over the K tiles in each
thread.

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


def posit_qgemm(a: torch.Tensor, w: torch.Tensor,
                cfg: PositConfig) -> torch.Tensor:
    """a: posit (M, K); w: posit (K, N) -> posit (M, N), quire-exact."""
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"pgemm contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(w.shape)}")
    if a.device.type == "cpu" and w.device.type == "cpu":
        return posit_qgemm_plain(a, w, cfg)
    _build.check_cfg(cfg, "posit_qgemm")
    for t in (a, w):
        if t.device.type != "cuda" or t.dtype != cfg.storage_dtype \
                or not t.is_contiguous():
            raise ValueError(f"posit_qgemm needs contiguous {cfg.storage_dtype} "
                             f"CUDA tensors, got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    m, k = a.shape
    n = w.shape[1]
    if m == 0 or n == 0 or k == 0:
        return zeros((m, n), cfg.storage_dtype, device=a.device)
    out = torch.empty((m, n), dtype=cfg.storage_dtype, device=a.device)
    lib = _build.load("posit_qgemm")
    rc = lib.posit_qgemm(cfg.nbits, cfg.es, a.data_ptr(), w.data_ptr(),
                         out.data_ptr(), m, k, n,
                         torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "posit_qgemm")
    launches["posit_qgemm"] += 1
    return out
