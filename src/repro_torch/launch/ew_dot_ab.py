"""Time ``csrc/posit_ew.cu`` and ``csrc/posit_dot.cu`` alone against a
second build of the two sources from another tree, at the shapes of
``chip_smoke.py``'s rows, in one process on one card; and count their
SASS instructions.

  git archive <commit> src/repro_torch/csrc | tar -x -C build/other
  PYTHONPATH=src python -m repro_torch.launch.ew_dot_ab \\
      build/other/src/repro_torch/csrc

The other tree's sources are the designs before vector passes and staged
rows, with their C interface: ``posit_elementwise(nbits, es, op, a, b,
out, n, na, nb, stream)`` (operands read at ``i % na``) and
``posit_dot_rows(nbits, es, a, b, out, rows, len, stream)``.

Shapes (random patterns from seeds): a ``vmul`` by 0.5 on one phi3
arena layer (512, 16, 10, 128) posit16 and on a whole 40-layer leaf,
the conv's bias ``vadd`` (95 048, 64) + (64,) posit32, a ``vdiv`` exact
of two layers, and the conv's dot (65 536 rows of 147 posit32).  Each
kernel alone is ``n`` back-to-back launches on preallocated outputs
between one CUDA event pair, divided by ``n``, in the turns other,
this, this, other; the two builds' outputs must be equal bit for bit.
Needs a CUDA card and ``nvcc``.  Prints the card line and one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.core.types import POSIT16, POSIT32, signed_view
from repro_torch.kernels import _build
from repro_torch.kernels import posit_codec as C
from repro_torch.kernels import posit_dot as D
from repro_torch.kernels import posit_ew as E

_OTHER = ("posit_ew", "posit_dot")


def build_other(csrc: Path, out_dir: Path) -> dict:
    """The other tree's two sources, built as the checkout's are."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in _OTHER:
        so = out_dir / f"other_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so),
             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}.cu of the other tree failed:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs["posit_ew"].posit_elementwise.argtypes = [I, I, I, P, P, P, LL, LL, LL, P]
    libs["posit_ew"].posit_elementwise.restype = I
    libs["posit_dot"].posit_dot_rows.argtypes = [I, I, P, P, P, LL, LL, P]
    libs["posit_dot"].posit_dot_rows.restype = I
    return libs


def alone_ms(call, n: int) -> float:
    for _ in range(2):
        if call() != 0:
            raise RuntimeError("a kernel-alone launch returned a CUDA error")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _random(cfg, shape, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen, dtype=torch.int64,
                      device=dev) if cfg.nbits == 32 else torch.randint(
        0, 2 ** cfg.nbits, shape, generator=gen, dtype=torch.int32, device=dev)
    return x.to(signed_view(torch.empty(0, dtype=cfg.storage_dtype)).dtype).view(
        cfg.storage_dtype)


def cases(dev):
    """name -> (cfg, op, div mode, a, b) of the elementwise rows, and the
    dot row's operands."""
    half = C.quantize_plain(torch.tensor([0.5]), POSIT16).to(dev)
    layer = (512, 16, 10, 128)
    x0, x1 = _random(POSIT16, layer, 1, dev), _random(POSIT16, layer, 2, dev)
    leaf = _random(POSIT16, (40,) + layer, 3, dev)
    y = _random(POSIT32, (95048, 64), 4, dev)
    bias = _random(POSIT32, (64,), 5, dev)
    ew = {"layer_vmul": (POSIT16, "mul", "nr3", x0, half, 100),
          "leaf_vmul": (POSIT16, "mul", "nr3", leaf, half, 10),
          "bias_vadd": (POSIT32, "add", "nr3", y, bias, 100),
          "layer_vdiv_exact": (POSIT16, "div", "exact", x0, x1, 20)}
    dot = (_random(POSIT32, (65536, 147), 6, dev), _random(POSIT32, (65536, 147), 7, dev))
    return ew, dot


def _same(x, y):
    return torch.equal(signed_view(x), signed_view(y))


def run(other_csrc: Path) -> dict:
    dev = torch.device("cuda")
    other = build_other(other_csrc, _build.BUILD_DIR / "other")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ew, (da, db) = cases(dev)
    res = {}
    for name, (cfg, op, mode, a, b, n) in ew.items():
        code = E._OP_CODE[(op, mode if op == "div" else "nr3")]
        new_call, new_out = E.elementwise_call(a, b, cfg, op, mode)
        old_out = torch.empty_like(new_out)
        fn = other["posit_ew"].posit_elementwise
        args = (cfg.nbits, cfg.es, code, a.data_ptr(), b.data_ptr(), old_out.data_ptr(),
                new_out.numel(), a.numel(), b.numel(), stream)
        old_call = lambda fn=fn, args=args: fn(*args)       # noqa: E731
        times = [alone_ms(c, n) for c in (old_call, new_call, new_call, old_call)]
        res[name] = dict(other_ms=(times[0] + times[3]) / 2, ms=(times[1] + times[2]) / 2,
                         turns=times, equal=_same(new_out, old_out),
                         shape=list(new_out.shape), cfg=cfg.name)
        del new_out, old_out
    new_call, new_out = D.vpdot_rows_call(da, db, POSIT32)
    old_out = torch.empty_like(new_out)
    fn = other["posit_dot"].posit_dot_rows
    args = (32, 2, da.data_ptr(), db.data_ptr(), old_out.data_ptr(), da.shape[0],
            da.shape[1], stream)
    old_call = lambda: fn(*args)                            # noqa: E731
    times = [alone_ms(c, 100) for c in (old_call, new_call, new_call, old_call)]
    res["conv_dot"] = dict(other_ms=(times[0] + times[3]) / 2, ms=(times[1] + times[2]) / 2,
                           turns=times, equal=_same(new_out, old_out),
                           shape=list(da.shape), cfg="posit32e2")
    return res


def _functions(sass: str) -> dict:
    """cuobjdump -sass text -> {mangled function: [(address, instruction)]}."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


# SASS opcodes that issue to the integer ALU pipe (16 lanes a partition,
# half the issue rate) and to the FMA pipe, which also takes IMAD
_ALU = {"IADD3", "LOP3", "SHF", "SEL", "ISETP", "FLO", "PRMT", "LEA", "IABS", "IMNMX",
        "VIMNMX", "BMSK", "SGXT", "POPC", "BREV", "PLOP3", "P2R", "R2P", "MOV", "FSEL"}
_FMA = {"IMAD", "IMUL", "FFMA", "FMUL", "FADD"}


def sass_counts(lib: Path, want) -> dict:
    """Per function whose name holds every string of one entry of
    ``want``: its SASS instructions, how many of them issue to the
    integer ALU and FMA pipes, and the instructions of its longest loop
    (the span from a backward branch's target to the branch)."""
    out = subprocess.run([str(Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass",
                          str(lib)], capture_output=True, text=True, timeout=600).stdout
    res = {}
    for fname, ins in _functions(out).items():
        tag = next((t for t, keys in want.items() if all(k in fname for k in keys)), None)
        if tag is None:
            continue
        loop, lo, hi = 0, 0, 0
        for addr, text in ins:
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr and addr - int(m.group(1), 16) >= 16 * loop:
                loop, lo, hi = (addr - int(m.group(1), 16)) // 16 + 1, int(m.group(1), 16), addr
        ops = [re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0] for _, t in ins]
        in_loop = [o for (a, _), o in zip(ins, ops) if lo <= a <= hi]
        res.setdefault(tag, []).append(dict(
            function=fname, instructions=len(ins), alu=sum(o in _ALU for o in ops),
            fma=sum(o in _FMA for o in ops), longest_loop=loop,
            loop_alu=sum(o in _ALU for o in in_loop), loop_fma=sum(o in _FMA for o in in_loop)))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other_csrc", type=Path, help="the other tree's csrc directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("ew_dot_ab needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    res = run(args.other_csrc)
    paths = _build.build_all()
    # the hot instantiations: posit16 vmul by a scalar (full x scalar),
    # the posit32 bias add (full x row), posit16 exact division (full x
    # full), the posit32 dot with 16 lanes a row (the conv's); and the
    # other tree's same (N, ES, OP) instances
    res["sass"] = {
        "posit_ew": sass_counts(paths["posit_ew"], {
            "vmul16_full_scalar": ("ew_kernel", "ILi16ELi2ELi2ELi0ELi1E"),
            "vadd32_full_row": ("ew_kernel", "ILi32ELi2ELi0ELi0ELi2E"),
            "vdiv16_exact_full_full": ("ew_kernel", "ILi16ELi2ELi4ELi0ELi0E")}),
        "posit_dot": sass_counts(paths["posit_dot"], {
            "dot32_g16": ("dot_kernel", "ILi32ELi2ELi16E")}),
        "other_posit_ew": sass_counts(_build.BUILD_DIR / "other" / "other_posit_ew.so", {
            "vmul16": ("ew_kernel", "ILi16ELi2ELi2E"),
            "vadd32": ("ew_kernel", "ILi32ELi2ELi0E"),
            "vdiv16_exact": ("ew_kernel", "ILi16ELi2ELi4E")}),
        "other_posit_dot": sass_counts(_build.BUILD_DIR / "other" / "other_posit_dot.so", {
            "dot32": ("dot_kernel", "ILi32ELi2E")}),
    }
    print(json.dumps(res))
    if not all(v["equal"] for k, v in res.items() if k != "sass"):
        sys.exit("the two builds disagree")


if __name__ == "__main__":
    main()
