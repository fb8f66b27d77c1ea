"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface (``build/<name>-<hash>.so`` at the repo
root), loaded through ``ctypes``.  The build runs at first use, from the
checkout's sources only; all sources compile in parallel, one ``nvcc``
each.  The file name carries a hash of the sources and flags, so an
edited source rebuilds and an unchanged one is reused.  A failed build
raises with the compiler's output.

Nothing here runs at import: the CPU tests import every module of the
port on hosts without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.core.types import CONFIGS

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build"
SOURCES = ("posit_codec", "posit_paged_write", "posit_paged_read", "paged_attn",
           "paged_attn_mla", "posit_ew", "posit_dot", "posit_qgemm", "posit_gemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: dict = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source that has no current library; returns
    ``{name: path}``.  Raises ``RuntimeError`` if any ``nvcc`` fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in SOURCES}
    todo = [n for n in SOURCES if not paths[n].exists()]
    if todo:
        nvcc = nvcc_path()
        procs = {}
        for n in todo:
            tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{out}")
            else:
                os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name`` (builds all on first use)."""
    if name not in _libs:
        paths = build_all()
        lib = ctypes.CDLL(str(paths[name]))
        _declare(name, lib)
        _libs[name] = lib
    return _libs[name]


def _declare(name: str, lib: ctypes.CDLL) -> None:
    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    if name == "posit_codec":
        lib.posit_quantize.argtypes = [I, I, P, P, LL, I, P]
        lib.posit_dequantize.argtypes = [I, I, I, I, P, P, P, I, P]
        for fn in (lib.posit_quantize, lib.posit_dequantize):
            fn.restype = I
    elif name == "posit_paged_write":
        for fn in (lib.posit_paged_write, lib.posit_paged_write_floor):
            fn.argtypes = [I, I, I, P, P, P, P, LL, LL, P]
            fn.restype = I
    elif name == "posit_paged_read":
        lib.posit_paged_read.argtypes = [I, I, I, P, P, P, P, I, I, P, P, P,
                                         I, I, I, I, P]
        lib.posit_paged_read.restype = I
    elif name == "posit_ew":
        lib.posit_elementwise.argtypes = [I, I, I, P, I, I, P, I, I, P, LL, I,
                                          P]
        lib.posit_elementwise.restype = I
    elif name == "posit_dot":
        lib.posit_dot_rows.argtypes = [I, I, P, P, P, LL, LL, I, P]
        lib.posit_dot_rows.restype = I
    elif name == "posit_qgemm":
        lib.posit_qgemm.argtypes = [I, I, P, P, P, P, LL, LL, LL, LL, P]
        lib.posit_qgemm.restype = I
        lib.posit_qgemm_workspace_bytes.argtypes = [LL, LL, LL]
        lib.posit_qgemm_workspace_bytes.restype = LL
    elif name == "posit_gemm":
        lib.posit_gemm.argtypes = [I, I, P, P, P, P, LL, LL, LL, I, I, P]
        lib.posit_gemm.restype = I
    elif name == "paged_attn":
        lib.paged_decode_attention.argtypes = [I] + [P] * 8 + [I] * 10 + [P]
        lib.paged_decode_attention.restype = I
    elif name == "paged_attn_mla":
        lib.paged_decode_attention_mla.argtypes = \
            [I] + [P] * 9 + [I] * 8 + [F, P]
        lib.paged_decode_attention_mla.restype = I
        lib.paged_attn_mla_smem_bytes.argtypes = [I] * 5
        lib.paged_attn_mla_smem_bytes.restype = LL


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA ``device`` (a torch device),
    read once per device; the wrappers size their grids by it."""
    return _sm_count(device.index if device.index is not None else 0)


def check_cfg(cfg, what: str) -> None:
    """Raise unless the kernels are instantiated for ``cfg`` (the five
    configs of ``core/types.py``, at the full alignment width)."""
    if cfg not in CONFIGS:
        raise ValueError(f"{what}: the CUDA kernels are built for "
                         f"{[c.name for c in CONFIGS]} (align_width 63), "
                         f"got {cfg}")


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: launch returned cudaError_t {rc}")
