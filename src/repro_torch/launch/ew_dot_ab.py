"""Time the port's kernels alone against a second build of their sources
from another tree, in one process on one card, and count their SASS
instructions.

  git archive <commit> src/repro_torch/csrc | tar -x -C build/other
  PYTHONPATH=src python -m repro_torch.launch.ew_dot_ab \\
      build/other/src/repro_torch/csrc [--quantizers | --dequantize]

Without ``--quantizers``: ``csrc/posit_ew.cu`` and ``csrc/posit_dot.cu``
against the designs before vector passes and staged rows, with their C
interface: ``posit_elementwise(nbits, es, op, a, b, out, n, na, nb,
stream)`` (operands read at ``i % na``) and ``posit_dot_rows(nbits, es, a,
b, out, rows, len, stream)``.  Shapes (random patterns from seeds): a
``vmul`` by 0.5 on one phi3 arena layer (512, 16, 10, 128) posit16 and on
a whole 40-layer leaf, the conv's bias ``vadd`` (95 048, 64) + (64,)
posit32, a ``vdiv`` exact of two layers, and the conv's dot (65 536 rows
of 147 posit32).

With ``--quantizers``: the two quantizers, ``csrc/posit_codec.cu``'s
quantize and ``csrc/posit_paged_write.cu``, against the designs before
the shared table encode (a thread an element through the 64-bit stream
encode; ``posit_quantize(nbits, es, x, out, n, stream)``, the write's C
interface unchanged).  Shapes: the quantize at P3's weight
(17 920 x 5 120 posit16), P2's images (8 x 3 x 224^2 posit32) and bias
(64 posit32); the write at a phi3 decode step's K and V (2 jobs x 8 rows
x 1 280, bf16 into posit16, one row dropped) and a prefill leaf (40
layers x 128 rows, 37 dropped), with both builds' device times from
``torch.profiler`` and, for the decode write, the launch floor (an empty
kernel through the same C call), ten pairs in turns with the 2- and the
128-job table.

With ``--dequantize``: the codec's dequantize against its design before
the job table (a thread an element, grid-stride, ``posit.cuh``'s
``to_f32``; ``posit_dequantize(nbits, es, p, out, n, stream)``, e.g.
``git archive 3def82d src/repro_torch/csrc``).  One leaf to f32 at phi3's
linear leaf (8, 1 024, 10, 128) posit16, minicpm3's latent (8, 1 024,
256) and RoPE key (8, 1 024, 32) posit16, P2's conv output (95 048, 64)
posit32; and the linear decode's reads of one layer as each design runs
them: phi3's K and V in one bf16-rounded launch against two launches and
four casts (to bf16 and back), minicpm3's latent and RoPE key in one
launch against two.  Random patterns from seeds, NaR among them; the
outputs must be equal bit for bit (a NaN only as NaN: torch's cast of
NaR's NaN to bf16 gives other bits than the kernel's, which keeps the
reference's).  SASS counts of both builds' hot instances.

Each kernel alone is ``n`` back-to-back launches on preallocated outputs
between one CUDA event pair, divided by ``n``, in the turns other, this,
this, other; the builds' outputs must be equal bit for bit.  Needs a CUDA card
and ``nvcc``.  Prints the card line and one JSON line.
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
from repro_torch.launch.timing import device_ms, kernel_alone_ms as alone_ms

_OTHER = ("posit_ew", "posit_dot")
_QUANT = ("posit_codec", "posit_paged_write")


def build_other(csrc: Path, out_dir: Path, names=_OTHER) -> dict:
    """Sources ``names`` of the tree ``csrc``, built as the checkout's are
    into ``other_<name>.so``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = out_dir / f"other_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so),
             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}.cu of {csrc} failed:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if "posit_ew" in libs:
        libs["posit_ew"].posit_elementwise.argtypes = [I, I, I, P, P, P, LL, LL, LL, P]
        libs["posit_ew"].posit_elementwise.restype = I
    if "posit_dot" in libs:
        libs["posit_dot"].posit_dot_rows.argtypes = [I, I, P, P, P, LL, LL, P]
        libs["posit_dot"].posit_dot_rows.restype = I
    if "posit_codec" in libs:      # the other tree's codec takes no SM count
        libs["posit_codec"].posit_quantize.argtypes = [I, I, P, P, LL, P]
        libs["posit_codec"].posit_dequantize.argtypes = [I, I, P, P, LL, P]
        for fn in (libs["posit_codec"].posit_quantize, libs["posit_codec"].posit_dequantize):
            fn.restype = I
    if "posit_paged_write" in libs:
        libs["posit_paged_write"].posit_paged_write.argtypes = [I, I, I, P, P, P, P, LL, LL, P]
        libs["posit_paged_write"].posit_paged_write.restype = I
    return libs


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


def quant_cases(dev):
    """name -> (cfg, f32 source, launches timed) of the quantize rows, and
    (arena leaf, decode jobs and slots, prefill jobs and slots) of the
    write rows, phase- and serving-like values from seeds."""
    gen = torch.Generator(device=dev).manual_seed(11)
    quant = {
        "p3_weight": (POSIT16, torch.randn((17920, 5120), generator=gen, device=dev)
                      * 17920 ** -0.5, 20),
        "p2_images": (POSIT32, torch.randint(0, 128, (8, 3, 224, 224), generator=gen,
                                             device=dev).float() * 0.02, 100),
        "p2_bias": (POSIT32, torch.randint(-127, 128, (64,), generator=gen,
                                           device=dev).float() * 0.005, 100)}
    n_layers, nb, bs, feat = 40, 512, 16, (10, 128)
    leaves = [torch.randint(-2 ** 15, 2 ** 15, (n_layers, nb, bs) + feat, generator=gen,
                            device=dev, dtype=torch.int16).view(torch.uint16)
              for _ in range(2)]
    perm = torch.randperm(nb * bs, generator=gen, device=dev)
    slots = perm[:8].clone()
    slots[3] = -1                                        # an inactive row
    n_valid = torch.tensor([16, 16, 3, 0, 16, 8, 16, 16], device=dev)
    pslots = perm[8:8 + 128].clone().view(8, 16)
    pslots[torch.arange(16, device=dev)[None, :] >= n_valid[:, None]] = -1
    one = [torch.randn((8,) + feat, generator=gen, device=dev).to(torch.bfloat16)
           for _ in range(2)]
    chunk = torch.randn((n_layers, 128) + feat, generator=gen, device=dev).to(torch.bfloat16)
    write = {"decode": (leaves, lambda arenas: [(a[0], x) for a, x in zip(arenas, one)],
                        slots),
             "prefill_leaf": (leaves[:1], lambda arenas: [(arenas[0][li], chunk[li])
                                                         for li in range(n_layers)],
                              pslots.reshape(-1).contiguous())}
    return quant, write


def _write_call(fn, jobs, slots, cfg, stream):
    """A call of a ``posit_paged_write`` C entry on ``jobs``."""
    n = len(jobs)
    args = (cfg.nbits, 1, n, (ctypes.c_void_p * n)(*[x.data_ptr() for _, x in jobs]),
            (ctypes.c_void_p * n)(*[a.data_ptr() for a, _ in jobs]),
            (ctypes.c_int * n)(*[a[0, 0].numel() for a, _ in jobs]), slots.data_ptr(),
            slots.numel(), jobs[0][0].shape[0] * jobs[0][0].shape[1], stream)
    return lambda: fn(*args)


def run_quantizers(other_csrc: Path) -> dict:
    """The quantizers in turns against the other tree's build; outputs
    equal bit for bit."""
    dev = torch.device("cuda")
    other = build_other(other_csrc, _build.BUILD_DIR / "other", _QUANT)
    stream = torch.cuda.current_stream(dev).cuda_stream
    quant, write = quant_cases(dev)
    res = {}

    def turns(calls, n):
        t = [alone_ms(c, n) for c in (calls[0], calls[1], calls[1], calls[0])]
        return dict(other_ms=(t[0] + t[3]) / 2, ms=(t[1] + t[2]) / 2, turns=t)

    for name, (cfg, x, n) in quant.items():
        call, out = C.quantize_call(x, cfg)
        o_out = torch.empty_like(out)
        o_call = lambda: other["posit_codec"].posit_quantize(      # noqa: E731
            cfg.nbits, cfg.es, x.data_ptr(), o_out.data_ptr(), x.numel(), stream)
        res[name] = dict(turns([o_call, call], n), shape=list(x.shape), cfg=cfg.name,
                         equal=_same(out, o_out))
        del out, o_out
    for name, (leaves, jobs_of, slots) in write.items():
        outs = {}
        for tag, fn in (("this", None), ("other", other["posit_paged_write"].posit_paged_write)):
            arenas = [a.clone() for a in leaves]
            call = C.paged_write_call(jobs_of(arenas), slots, POSIT16) if fn is None else \
                _write_call(fn, jobs_of(arenas), slots, POSIT16, stream)
            if call() != 0:
                raise RuntimeError(f"the {tag} paged write failed")
            outs[tag] = (arenas, call)
        equal = all(_same(a, b) for a, b in zip(outs["this"][0], outs["other"][0]))
        res[name] = dict(turns([outs[t][1] for t in ("other", "this")], 100),
                         shape=[len(jobs_of(leaves)), slots.numel(), 10, 128],
                         kept_rows=int((slots >= 0).sum()), cfg="posit16e2", equal=equal,
                         device_ms={t: device_ms(outs[t][1], "paged_write_kernel")
                                    for t in ("other", "this")})
        if name == "decode":
            # the launch floor: an empty kernel through the same C call, with
            # this launch's 2-job table and (a third job) the 128-job one,
            # ten pairs in turns 2, 128, 128, 2, ...
            jobs = jobs_of(outs["this"][0])
            floors = (C.paged_write_call(jobs, slots, POSIT16, floor=True),
                      C.paged_write_call(jobs + jobs[:1], slots, POSIT16, floor=True))
            pairs = []
            for i in range(10):
                t = [alone_ms(floors[(i + k) % 2], 100) for k in (0, 1)]
                pairs.append(t if i % 2 == 0 else t[::-1])
            res[name].update(floor_pairs=pairs,
                             floor_ms=sum(p[0] for p in pairs) / 10,
                             floor_128_ms=sum(p[1] for p in pairs) / 10,
                             floor_2_faster=sum(p[0] < p[1] for p in pairs))
        del outs
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
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--quantizers", action="store_true",
                      help="the quantize and the fused paged write instead of ew and dot")
    mode.add_argument("--dequantize", action="store_true",
                      help="the codec's dequantize instead of ew and dot")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("ew_dot_ab needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    if args.quantizers:
        res = run_quantizers(args.other_csrc)
        res["sass"] = quantizer_sass()
    elif args.dequantize:
        res = run_dequantize(args.other_csrc)
        res["sass"] = dequantize_sass()
    else:
        res = ew_dot(args.other_csrc)
    print(json.dumps(res))
    if not all(v["equal"] for k, v in res.items() if k != "sass"):
        sys.exit("the builds disagree")


def quantizer_sass() -> dict:
    """SASS counts of the quantizers' hot instances (posit16 and posit32
    quantize; the bf16 -> posit16 write with the 2- and the 128-job
    table) in this build and the other tree's, with
    the longest loop's instructions per element (a trip of the loop
    encodes 16 elements a thread in the quantize, 32 a lane in the
    write; one in the other tree's kernels)."""
    paths = _build.build_all()
    out = _build.BUILD_DIR / "other"
    this_q = {"quantize16": ("15quantize_kernel", "ILi16ELi2Et"),
              "quantize32": ("15quantize_kernel", "ILi32ELi2Ej")}
    this_w = {"write16_bf16_jobs2": ("paged_write_kernel", "ILi16EttLi2E"),
              "write16_bf16_jobs128": ("paged_write_kernel", "ILi16EttLi128E")}
    res = {"posit_codec": sass_counts(paths["posit_codec"], this_q),
           "posit_paged_write": sass_counts(paths["posit_paged_write"], this_w),
           "other_posit_codec": sass_counts(out / "other_posit_codec.so", this_q),
           "other_posit_paged_write": sass_counts(out / "other_posit_paged_write.so", {
               "write16_bf16": ("paged_write_kernel", "ILi16Et13__nv_bfloat16E")})}
    for lib, tags in res.items():
        per_trip = 1 if lib.startswith("other") else (16 if "codec" in lib else 32)
        for entries in tags.values():
            for e in entries:
                e["loop_per_element"] = e["longest_loop"] / per_trip
                e["loop_alu_per_element"] = e["loop_alu"] / per_trip
    return res


def ew_dot(other_csrc: Path) -> dict:
    """posit_ew and posit_dot in turns against the other tree's, with
    their SASS counts."""
    res = run(other_csrc)
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
    return res


def _same_values(x, y):
    """f32 tensors equal bit for bit, a NaN only as a NaN."""
    nan = torch.isnan(x)
    return torch.equal(nan, torch.isnan(y)) and torch.equal(
        x.view(torch.int32)[~nan], y.view(torch.int32)[~nan])


def run_dequantize(other_csrc: Path) -> dict:
    """The dequantize in turns against the other tree's build: one leaf
    to f32, and the linear decode's reads of a layer in each design's
    launches; outputs equal."""
    dev = torch.device("cuda")
    other = build_other(other_csrc, _build.BUILD_DIR / "other", ("posit_codec",))
    fn = other["posit_codec"].posit_dequantize
    stream = torch.cuda.current_stream(dev).cuda_stream
    leaves = {"phi3_leaf": (POSIT16, (8, 1024, 10, 128)),
              "mla_latent": (POSIT16, (8, 1024, 256)),
              "mla_rope": (POSIT16, (8, 1024, 32)),
              "p2_conv_out": (POSIT32, (95048, 64))}
    res = {}

    def turns(calls, n=100):
        t = [alone_ms(c, n) for c in (calls[0], calls[1], calls[1], calls[0])]
        return dict(other_ms=(t[0] + t[3]) / 2, ms=(t[1] + t[2]) / 2, turns=t)

    def old_call(cfg, p):
        out = torch.empty(p.shape, dtype=torch.float32, device=dev)
        return (lambda: fn(cfg.nbits, cfg.es, p.data_ptr(), out.data_ptr(), p.numel(),
                           stream)), out

    pats = {}
    for i, (name, (cfg, shape)) in enumerate(leaves.items()):
        p = _random(cfg, shape, 20 + i, dev)
        pats[name] = p
        call, out = C.dequantize_call(p, cfg)
        o_call, o_out = old_call(cfg, p)
        if call() != 0 or o_call() != 0:
            raise RuntimeError(f"a dequantize launch failed at {name}")
        res[name] = dict(turns([o_call, call]), shape=list(shape), cfg=cfg.name,
                         equal=_same_values(out, o_out))
        del out, o_out
    # the linear reads of one layer: phi3's K and V (a second leaf from
    # another seed), minicpm3's latent and RoPE key
    kv = [pats["phi3_leaf"], _random(POSIT16, leaves["phi3_leaf"][1], 30, dev)]
    for name, ps, round_to in (("phi3_layer_kv_bf16", kv, torch.bfloat16),
                               ("mla_layer_cr", [pats["mla_latent"], pats["mla_rope"]],
                                None)):
        call, outs = C.dequantize_many_call(ps, POSIT16, round_to)
        olds = [old_call(POSIT16, p) for p in ps]
        casts = []
        if round_to is not None:
            for _, o in olds:
                b = torch.empty(o.shape, dtype=torch.bfloat16, device=dev)
                casts += [(b, o), (o, b)]

        def o_chain(olds=olds, casts=casts):
            for c, _ in olds:
                c()
            for dst, src in casts:
                dst.copy_(src)
            return 0

        if call() != 0 or o_chain() != 0:
            raise RuntimeError(f"a dequantize launch failed at {name}")
        res[name] = dict(turns([o_chain, call]), launches=1, other_launches=len(olds) + len(casts),
                         shape=[list(p.shape) for p in ps], cfg="posit16e2",
                         round_to=None if round_to is None else str(round_to),
                         equal=all(_same_values(a, o) for a, (_, o) in zip(outs, olds)))
        del outs, olds, casts
    return res


def dequantize_sass() -> dict:
    """SASS counts of the dequantize's instances (posit16 to f32 and
    bf16-rounded, posit8, posit32) in this build and the other tree's,
    with the longest loop's instructions per element (a trip decodes four
    units of four patterns a thread, two of posit32: 16 posit8 or posit16,
    8 posit32; one in the other tree's kernel)."""
    paths = _build.build_all()
    res = {"posit_codec": sass_counts(paths["posit_codec"], {
        "dequantize16_f32": ("17dequantize_kernel", "ILi16ELi2EtLb0E"),
        "dequantize16_bf16": ("17dequantize_kernel", "ILi16ELi2EtLb1E"),
        "dequantize8_f32": ("17dequantize_kernel", "ILi8ELi2EhLb0E"),
        "dequantize32_f32": ("17dequantize_kernel", "ILi32ELi2EjLb0E")}),
        "other_posit_codec": sass_counts(_build.BUILD_DIR / "other" / "other_posit_codec.so", {
            "dequantize16": ("17dequantize_kernel", "ILi16ELi2EtE"),
            "dequantize8": ("17dequantize_kernel", "ILi8ELi2EhE"),
            "dequantize32": ("17dequantize_kernel", "ILi32ELi2EjE")})}
    per_trip = {"16": 16, "8": 16, "32": 8}
    for lib, tags in res.items():
        for tag, entries in tags.items():
            n = 1 if lib.startswith("other") else per_trip[tag[10:].split("_")[0]]
            for e in entries:
                e["loop_per_element"] = e["longest_loop"] / n
                e["loop_alu_per_element"] = e["loop_alu"] / n
    return res


if __name__ == "__main__":
    main()
