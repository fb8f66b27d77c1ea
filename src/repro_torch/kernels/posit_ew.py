"""Fused elementwise PVU ops on posit patterns: vadd, vsub, vmul, vdiv (CUDA).

Replaces ``repro/kernels/posit_ew.py`` ``elementwise_2d`` (the Pallas
TPU kernel ``_ew_kernel``): decode -> PIR add/sub/mul/div -> one RNE
encode with the sticky bit, no f32 round trip (``csrc/posit_ew.cu``,
the arithmetic of ``csrc/pvu.cuh``).

Bound on the H100: by operations (the datapath's 45-181 integer
operations an element against 2-12 bytes), at the card's issue rate.
The kernel moves 16-byte vectors, several in flight a thread, and
reads each operand in one of three modes the wrapper picks: ``full``
(the output's shape), ``scalar`` (one pattern, decoded once per
thread) or ``row`` (a suffix of C patterns, such as a bias row, read at
i mod C with a running column).  An operand whose shape is a suffix of
the output's is read in place, never broadcast into memory; ragged
heads, tails and misaligned views are handled inside the kernel.

On a CPU tensor the wrapper runs the plain version (``core.posit``); on
a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import posit as P
from repro_torch.core.types import PositConfig, signed_view

from . import _build

OPS = ("add", "sub", "mul", "div")
DIV_MODES = ("nr3", "exact")
_OP_CODE = {("add", "nr3"): 0, ("sub", "nr3"): 1, ("mul", "nr3"): 2,
            ("div", "nr3"): 3, ("div", "exact"): 4}

launches = {"posit_ew": 0}


def _check_op(op: str, div_mode: str):
    if op not in OPS or div_mode not in DIV_MODES:
        raise ValueError(f"unknown elementwise op {op!r} / div mode "
                         f"{div_mode!r}")


def elementwise_plain(a, b, cfg: PositConfig, op: str,
                      div_mode: str = "nr3") -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``core.posit`` on the
    broadcast operands."""
    _check_op(op, div_mode)
    if op == "add":
        return P.vpadd(a, b, cfg)
    if op == "sub":
        return P.vpsub(a, b, cfg)
    if op == "mul":
        return P.vpmul(a, b, cfg)
    return P.vpdiv(a, b, cfg, mode=div_mode)


def _suffix_operand(x: torch.Tensor, shape) -> torch.Tensor:
    """``x`` as a contiguous tensor the kernel can read at ``i % numel``:
    as it is when its shape (without leading ones) is a suffix of
    ``shape``, otherwise broadcast into memory."""
    core = list(x.shape)
    while core and core[0] == 1:
        core.pop(0)
    s = signed_view(x)
    if core != list(shape[len(shape) - len(core):]):
        s = s.expand(shape)
    return s.contiguous().view(x.dtype)


# operand modes of csrc/posit_ew.cu: the output's shape, one pattern, a
# suffix of C patterns read at i mod C
_FULL, _SCALAR, _ROW = 0, 1, 2


def _mode(x: torch.Tensor, n: int) -> int:
    return _FULL if x.numel() == n else (_SCALAR if x.numel() == 1 else _ROW)


def _prepare(a, b, cfg, op, div_mode):
    """Checks, operands and output of one call; returns ``(call, out)``
    with ``call()`` the kernel's C call (returns its CUDA error code), or
    None when the output is empty."""
    _check_op(op, div_mode)
    _build.check_cfg(cfg, "posit_ew")
    for t in (a, b):
        if t.device.type != "cuda" or t.dtype != cfg.storage_dtype:
            raise ValueError(f"posit_ew needs {cfg.storage_dtype} CUDA tensors, "
                             f"got {t.dtype} on {t.device}")
    if a.device != b.device:
        raise ValueError(f"posit_ew operands on {a.device} and {b.device}")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a, b = _suffix_operand(a, shape), _suffix_operand(b, shape)
    out = torch.empty(shape, dtype=cfg.storage_dtype, device=a.device)
    n = math.prod(shape)
    if n == 0:
        return None, out
    # two suffixes of one broadcast shape: the longer is the output's, so
    # at most one operand is not full
    ma, mb = _mode(a, n), _mode(b, n)
    cols = [x.numel() if m == _ROW else 0 for x, m in ((a, ma), (b, mb))]
    if max(cols) >= 2 ** 31:
        raise ValueError(f"posit_ew: a suffix operand of {max(cols)} elements "
                         f"(the kernel's column counter is 32-bit)")
    lib = _build.load("posit_ew")
    code = _OP_CODE[(op, div_mode if op == "div" else "nr3")]
    args = (cfg.nbits, cfg.es, code, a.data_ptr(), ma, cols[0], b.data_ptr(),
            mb, cols[1], out.data_ptr(), n, _build.sm_count(a.device),
            torch.cuda.current_stream(a.device).cuda_stream)
    fn = lib.posit_elementwise
    return (lambda: fn(*args)), out


def elementwise(a: torch.Tensor, b: torch.Tensor, cfg: PositConfig,
                op: str, div_mode: str = "nr3") -> torch.Tensor:
    """Fused posit op on two pattern tensors (``cfg.storage_dtype``) that
    broadcast against each other -> patterns of the broadcast shape."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return elementwise_plain(a, b, cfg, op, div_mode)
    call, out = _prepare(a, b, cfg, op, div_mode)
    if call is not None:
        _build.check(call(), "posit_ew")
        launches["posit_ew"] += 1
    return out


def elementwise_call(a, b, cfg: PositConfig, op: str, div_mode: str = "nr3"):
    """For timing the kernel alone: ``(call, out)``, where ``call()``
    launches the kernel once more on the same operands and output and
    returns the CUDA error code.  Not counted in ``launches``; CUDA
    tensors of a non-empty output only."""
    return _prepare(a, b, cfg, op, div_mode)
