"""GPU smoke test of the PyTorch/CUDA port: builds the kernels, holds each
against its plain PyTorch version on the card, then serves a Poisson
trace with phi3-medium-14b at full width through the port's main path
(continuous batching, chunked prefill, paged posit16 KV, fused paged
decode attention) and checks that every kernel ran there.

    python3 chip_smoke.py          # needs one NVIDIA GPU and nvcc

Prints the card's name and power limit, per-kernel checks and timings,
the serving report, a JSON line with every kernel's numbers and, last,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that line; without a GPU it exits non-zero at once.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
ATTN_TOL = 1e-5                # atol and rtol, kernel vs plain, both f32

# the main path: phi3-medium-14b at full width and depth, bf16 weights
SERVE_ARGV = [
    "--arch", "phi3-medium-14b", "--batch", "8", "--n-requests", "16",
    "--arrival-rate", "0.5", "--prompt-len", "512", "--gen", "32",
    "--max-len", "1024", "--chunk-size", "16", "--block-size", "16",
    "--kv-posit", "posit16", "--decode-kernel", "fused",
    "--temperature", "0", "--seed", "0", "--device", "cuda",
]


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def time_ms(fn, iters=20, warmup=3):
    """Median of per-call CUDA-event times, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_codec(dev):
    """Every posit16 and posit8 pattern decoded, a seeded f32 sweep with
    specials encoded: bit-exact against the plain versions."""
    from repro_torch.core.types import POSIT8, POSIT16
    from repro_torch.kernels import posit_codec as C

    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, 1 << 20, dtype=np.uint64).astype(np.uint32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                         1.1754942e-38, 3.4028235e38, 1.0, -1.0, 1e-30,
                         1e30], np.float32)
    x = torch.from_numpy(np.concatenate([bits.view(np.float32), specials]))
    for cfg in (POSIT16, POSIT8):
        pats = torch.arange(1 << cfg.nbits, dtype=torch.int64).to(cfg.storage_dtype)
        got = C.dequantize(pats.to(dev), cfg).cpu()
        ref = C.dequantize_plain(pats, cfg)
        bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        print(f"codec {cfg.name}: decode all {pats.numel()} patterns, "
              f"{bad} mismatches")
        if bad:
            fail(f"posit_dequantize {cfg.name} not bit-exact")
        got = C.quantize(x.to(dev), cfg).cpu()
        bad = int((got != C.quantize_plain(x, cfg)).sum())
        print(f"codec {cfg.name}: encode {x.numel()} f32 values, "
              f"{bad} mismatches")
        if bad:
            fail(f"posit_quantize {cfg.name} not bit-exact")


def time_codec(dev, cfg):
    """Kernel vs plain times at the main path's shapes: quantize at a
    prefill chunk's K (8 rows x 16 tokens x 10 heads x 128), dequantize
    at the chunked-prefill arena read (8 x 1024 slots x 10 x 128)."""
    from repro_torch.core.types import signed_view
    from repro_torch.kernels import posit_codec as C

    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((8, 16, 10, 128), generator=gen, device=dev)
    p = C.quantize_plain(torch.randn((8, 1024, 10, 128), generator=gen,
                                     device=dev), cfg)
    rows = []
    for name, fn, plain, arg, in_b, out_b, replaces in (
            ("posit_quantize", C.quantize, C.quantize_plain, x, 4, 2,
             "src/repro/kernels/posit_codec.py:46"),
            ("posit_dequantize", C.dequantize, C.dequantize_plain, p, 2, 4,
             "src/repro/kernels/posit_codec.py:61")):
        got, ref = fn(arg, cfg), plain(arg, cfg)
        exact = torch.equal(signed_view(got), signed_view(ref)) \
            if got.dtype != torch.float32 else \
            torch.equal(got.view(torch.int32), ref.view(torch.int32))
        if not exact:
            fail(f"{name} differs from its plain version at {tuple(arg.shape)}")
        n = arg.numel()
        nbytes = n * (in_b + out_b)
        rows.append(dict(
            name=name, route="cuda", source="src/repro_torch/csrc/posit_codec.cu",
            replaces=replaces, launches=0, max_abs_err=0.0,
            ms=time_ms(lambda: fn(arg, cfg)),
            plain_ms=time_ms(lambda: plain(arg, cfg), iters=5),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None, shape=list(arg.shape)))
    return rows


def attn_case(dev, kv, window, seed):
    """Full-width phi3 decode attention: B=8 rows, G=10 KV heads, R=4,
    D=128, block 16, W=64 table slots; ragged lens, sentinel tails, one
    all-masked row (its table is all sentinels)."""
    from repro_torch.kernels import posit_codec as C
    from repro_torch.models import layers as L

    b, g, r, d, bs, w = 8, 10, 4, 128, 16, 64
    lens = [1000, 700, 512, 300, 900, 64, 1020, 0]
    if window:
        lens = [1500, 2047, 512, 300, 1800, 64, 1020, 0]
    nb = b * w
    gen = torch.Generator(device=dev).manual_seed(seed)
    tables = torch.full((b, w), nb, dtype=torch.int32)
    perm = torch.randperm(nb, generator=torch.Generator().manual_seed(seed))
    for i, n in enumerate(lens[:-1]):
        live = w if window else -(-(n + 1) // bs)
        tables[i, :live] = perm[i * w:i * w + live].to(torch.int32)
    tables = tables.to(dev)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    apos = L.paged_apos(tables, lens, bs, nb, window=window)
    pcfg = L.pcfg(kv)
    k = C.quantize_plain(torch.randn((nb, bs, g, d), generator=gen, device=dev), pcfg)
    v = C.quantize_plain(torch.randn((nb, bs, g, d), generator=gen, device=dev), pcfg)
    q = torch.randn((b, g, r, d), generator=gen, device=dev) * d ** -0.5
    return (q, k, v, tables, apos, lens), pcfg


def check_attention(dev):
    from repro_torch.kernels import posit_paged_attn as K
    from repro_torch.models import layers as L

    row = None
    for window in (0, 1008):
        for kv in ("posit16", "posit8"):
            args, pcfg = attn_case(dev, kv, window, seed=2)
            got = K.paged_decode_attention(*args, pcfg=pcfg, window=window)
            ref = K.paged_decode_attention_plain(*args, pcfg=pcfg, window=window)
            err = float((got - ref).abs().max())
            ok = torch.allclose(got, ref, atol=ATTN_TOL, rtol=ATTN_TOL)
            zero = bool((got[-1] == 0).all())
            lane = f"window={window}" if window else "dense"
            print(f"paged attention {lane} {kv}: max abs err {err:.3e} "
                  f"(tolerance atol=rtol={ATTN_TOL}), all-masked row exact "
                  f"zeros: {zero}")
            if not ok or not zero:
                fail(f"paged_decode_attention {lane} {kv} disagrees with plain")
            if window == 0 and kv == "posit16":
                row = time_attention(args, pcfg, err)
    return row


def time_attention(args, pcfg, err):
    """Kernel, plain and SDPA-yardstick times on the dense posit16 case;
    the bound counts the live blocks this case's tables name."""
    from repro_torch.kernels import posit_codec as C
    from repro_torch.kernels import posit_paged_attn as K
    from repro_torch.models import layers as L

    q, k, v, tables, apos, lens = args
    b, g, r, d = q.shape
    nb, bs = k.shape[0], k.shape[1]
    live_slots = int((tables < nb).sum()) * bs
    kv_bytes = live_slots * g * 2 * d * k.element_size()
    io_bytes = (q.numel() * 4 * 2 + tables.numel() * 4 + apos.numel() * 4
                + lens.numel() * 4)
    flops = live_slots * g * r * 2 * (d + d)
    bound_ms = max((kv_bytes + io_bytes) / HBM_BYTES_PER_S,
                   flops / FP32_FLOPS) * 1e3
    bound_by = "bytes" if (kv_bytes + io_bytes) / HBM_BYTES_PER_S >= \
        flops / FP32_FLOPS else "operations"

    # yardstick: one SDPA call on the gathered, dequantized KV (timed
    # here only; the port never calls it)
    kk = C.dequantize_plain(L.paged_gather(k, tables), pcfg)      # (B,T,G,D)
    vv = C.dequantize_plain(L.paged_gather(v, tables), pcfg)
    cl = (lens + 1)[:, None]
    mask = ((apos >= 0) & (apos < cl))[:, None, None, :]          # (B,1,1,T)
    qh = q.reshape(b, g * r, 1, d) * d ** 0.5
    kh, vh = kk.permute(0, 2, 1, 3), vv.permute(0, 2, 1, 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib():
        return sdpa(qh, kh, vh, attn_mask=mask, enable_gqa=True)

    lib()
    return dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/csrc/paged_attn.cu",
        replaces="src/repro/kernels/posit_paged_attn.py:216", launches=0,
        max_abs_err=err,
        ms=time_ms(lambda: K.paged_decode_attention(*args, pcfg=pcfg)),
        plain_ms=time_ms(lambda: K.paged_decode_attention_plain(*args, pcfg=pcfg),
                         iters=5),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=time_ms(lib),
        shape=[b, g, r, d, int(tables.shape[1]), bs])


def serve_main_path():
    """The user entry point at full width; returns the launch counts of
    exactly this run and the serving result."""
    from repro_torch.kernels import posit_codec as C
    from repro_torch.kernels import posit_paged_attn as K
    from repro_torch.launch import serve

    counters = {**C.launches, **K.launches}
    for d in (C.launches, K.launches):
        for name in d:
            d[name] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve.main(SERVE_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**C.launches, **K.launches}
    assert set(counts) == set(counters)
    return res, counts, wall


def check_served(res):
    """Every request completed, every token in the vocabulary, and the
    block pool drained."""
    sched = res.sched
    vocab = sched.engine.cfg.vocab
    if len(res.done) != 16:
        fail(f"served {len(res.done)} of 16 requests")
    for c in res.done.values():
        if c.tokens.size == 0 or c.tokens.min() < 0 or c.tokens.max() >= vocab:
            fail(f"request {c.rid} produced out-of-vocabulary tokens")
    if sched.pool.n_free != sched.n_blocks:
        fail(f"{sched.n_blocks - sched.pool.n_free} blocks leaked")


def check_fused_equals_gather(dev):
    """The repo's own invariant on a small input, on the card: the fused
    decode kernel and the gather path give the same greedy tokens."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.serve import drive_trace, poisson_trace
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.scheduler import Scheduler

    cfg = dataclasses.replace(
        configs.get_config("phi3-medium-14b").reduced(compute_dtype="float32"),
        kv_posit="posit16")
    params = T.init_params(cfg, seed=3, device=dev)
    trace = poisson_trace(np.random.default_rng(3), 6, 0.5, cfg.vocab, 24, 12)
    streams = []
    for kernel in ("fused", "gather"):
        eng = Engine(cfg, params, max_len=48, block_size=4,
                     decode_kernel=kernel, device=dev)
        done, order = drive_trace(Scheduler(eng, n_slots=3, chunk_size=4), trace)
        streams.append({order[r]: c.tokens.tolist() for r, c in done.items()})
    same = streams[0] == streams[1]
    print(f"small input (reduced phi3, posit16 KV): fused == gather tokens: "
          f"{same}")
    if not same:
        fail("fused decode kernel and gather path disagree on the card")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core.types import POSIT16
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"({', '.join(_build.SOURCES)})")

    check_codec(dev)
    rows = time_codec(dev, POSIT16)
    rows.append(check_attention(dev))
    for row in rows:
        print(f"{row['name']} at {row['shape']}: {row['ms']:.4f} ms "
              f"(bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
              f"plain {row['plain_ms']:.4f} ms, library "
              f"{row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 4)} ms)")

    res, counts, wall = serve_main_path()
    check_served(res)
    st = res.sched.stats
    useful = sum(len(c.tokens) for c in res.done.values())
    arena = sum(res.sched.cache[k].numel() * res.sched.cache[k].element_size()
                for k in ("k", "v"))
    peak_arena = arena * res.sched.pool.peak_in_use // res.sched.n_blocks
    print(f"main path: phi3-medium-14b full width, {len(res.done)} requests, "
          f"{useful} tokens in {res.seconds:.2f} s ({wall:.2f} s with init); "
          f"goodput {useful / max(res.sched.steps_run, 1):.3f} tok/step, "
          f"{useful / res.seconds:.2f} tok/s; step wall p50 "
          f"{st['step_wall_p50_ms']:.1f} ms p99 {st['step_wall_p99_ms']:.1f} ms; "
          f"peak arena bytes {peak_arena:,} of {arena:,}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"main path kernel launches: {counts}")
    for row in rows:
        row["launches"] = counts[row["name"]]
        if row["launches"] <= 0:
            fail(f"kernel {row['name']} was not launched on the main path")

    check_fused_equals_gather(dev)

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
