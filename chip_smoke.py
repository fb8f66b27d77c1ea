"""GPU smoke test of the PyTorch/CUDA port: builds the kernels, holds each
against its plain PyTorch version on the card, then serves two Poisson
traces at full width through the port's main path (continuous batching,
chunked prefill, paged posit16 KV, fused paged decode attention) and
checks that every kernel of each path ran there:

- phi3-medium-14b (dense GQA lane, ``paged_attn.cu``);
- minicpm3-4b (MLA lane, ``paged_attn_mla.cu``) with prefix caching and
  deadlines on a shared-prefix trace of interactive and best-effort
  requests, on an arena small enough that deadlines preempt.

    python3 chip_smoke.py          # needs one NVIDIA GPU and nvcc

Prints the card's name and power limit, per-kernel checks and timings,
the serving reports, a JSON line with every kernel's numbers and, last,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that line; without a GPU it exits non-zero at once.
"""
from __future__ import annotations

import gc
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

_TRACE = [
    "--batch", "8", "--n-requests", "16", "--arrival-rate", "0.5",
    "--prompt-len", "512", "--gen", "32", "--max-len", "1024",
    "--chunk-size", "16", "--block-size", "16", "--kv-posit", "posit16",
    "--decode-kernel", "fused", "--temperature", "0", "--seed", "0",
    "--device", "cuda",
]
# the main path, two lanes at full width and depth, bf16 weights.  The
# minicpm3 trace shares half of every prompt; a quarter of its requests
# carry a 5 s deadline (500 decode steps) and the rest are best-effort,
# and its 200-block arena (of a worst case 512) makes deadline requests
# preempt best-effort rows: 9 prefix hits and 3 preemptions in 47 rounds.
# The schedule does not depend on width or tokens;
# tests/test_torch_prefix.py pins it on the CPU with the model stubbed.
MAIN_PATHS = {
    "phi3-medium-14b": (["--arch", "phi3-medium-14b"] + _TRACE,
                        ("posit_quantize", "posit_dequantize",
                         "paged_decode_attention")),
    "minicpm3-4b": (["--arch", "minicpm3-4b", "--prefix-cache",
                     "--prefix-share", "0.5", "--deadline-ms", "5000",
                     "--deadline-share", "0.25", "--n-blocks", "200"] + _TRACE,
                    ("posit_quantize", "posit_dequantize",
                     "paged_decode_attention_mla")),
}


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


def mla_case(dev, kv, seed):
    """Full-width minicpm3-4b latent decode attention: B=8 rows, H=40
    heads, rank 256, rope 32, block 16, W=64 table slots; ragged lens,
    sentinel tails, one all-masked row (its table is all sentinels)."""
    from repro_torch.kernels import posit_codec as C
    from repro_torch.models import layers as L

    b, h, rank, rope, bs, w = 8, 40, 256, 32, 16, 64
    lens = [1000, 700, 512, 300, 900, 64, 1020, 0]
    nb = b * w
    gen = torch.Generator(device=dev).manual_seed(seed)
    tables = torch.full((b, w), nb, dtype=torch.int32)
    perm = torch.randperm(nb, generator=torch.Generator().manual_seed(seed))
    for i, n in enumerate(lens[:-1]):
        live = -(-(n + 1) // bs)
        tables[i, :live] = perm[i * w:i * w + live].to(torch.int32)
    tables = tables.to(dev)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    apos = L.paged_apos(tables, lens, bs, nb)
    pcfg = L.pcfg(kv)
    c = C.quantize_plain(torch.randn((nb, bs, rank), generator=gen, device=dev), pcfg)
    r = C.quantize_plain(torch.randn((nb, bs, rope), generator=gen, device=dev), pcfg)
    q_lat = torch.randn((b, h, rank), generator=gen, device=dev)
    q_rope = torch.randn((b, h, rope), generator=gen, device=dev)
    return (q_lat, q_rope, c, r, tables, apos, lens), pcfg


def check_attention_mla(dev):
    from repro_torch.kernels import posit_paged_attn as K

    scale = (64 + 32) ** -0.5
    row = None
    for kv in ("posit16", "posit8"):
        args, pcfg = mla_case(dev, kv, seed=4)
        got = K.paged_decode_attention_mla(*args, pcfg=pcfg, scale=scale)
        ref = K.paged_decode_attention_mla_plain(*args, pcfg=pcfg, scale=scale)
        err = float((got - ref).abs().max())
        ok = torch.allclose(got, ref, atol=ATTN_TOL, rtol=ATTN_TOL)
        zero = bool((got[-1] == 0).all())
        print(f"paged attention MLA {kv}: max abs err {err:.3e} (tolerance "
              f"atol=rtol={ATTN_TOL}), all-masked row exact zeros: {zero}")
        if not ok or not zero:
            fail(f"paged_decode_attention_mla {kv} disagrees with plain")
        if kv == "posit16":
            row = time_attention_mla(args, pcfg, scale, err)
    return row


def time_attention_mla(args, pcfg, scale, err):
    """Kernel, plain and SDPA-yardstick times on the posit16 case; the
    bound counts the live blocks this case's tables name."""
    from repro_torch.kernels import posit_codec as C
    from repro_torch.kernels import posit_paged_attn as K
    from repro_torch.models import layers as L

    q_lat, q_rope, c, r, tables, apos, lens = args
    b, h, rank = q_lat.shape
    rope = q_rope.shape[-1]
    nb, bs = c.shape[0], c.shape[1]
    live_slots = int((tables < nb).sum()) * bs
    kv_bytes = live_slots * (rank + rope) * c.element_size()
    io_bytes = (q_lat.numel() * 4 * 2 + q_rope.numel() * 4
                + tables.numel() * 4 + apos.numel() * 4 + lens.numel() * 4)
    flops = live_slots * h * (2 * (rank + rope) + 2 * rank)
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS
    # yardstick: one SDPA call on the gathered, dequantized latents, K
    # the latent and RoPE parts concatenated, V the latent (timed here
    # only; the port never calls it)
    cc = C.dequantize_plain(L.paged_gather(c, tables), pcfg)      # (B,T,rank)
    rr = C.dequantize_plain(L.paged_gather(r, tables), pcfg)
    kk = torch.cat([cc, rr], -1)[:, None]                          # (B,1,T,288)
    vv = cc[:, None]
    qq = torch.cat([q_lat, q_rope], -1)[:, :, None]                # (B,H,1,288)
    mask = ((apos >= 0) & (apos < (lens + 1)[:, None]))[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib():
        return sdpa(qq, kk, vv, attn_mask=mask, scale=scale, enable_gqa=True)

    lib()
    return dict(
        name="paged_decode_attention_mla", route="cuda",
        source="src/repro_torch/csrc/paged_attn_mla.cu",
        replaces="src/repro/kernels/posit_paged_attn.py:262", launches=0,
        max_abs_err=err,
        ms=time_ms(lambda: K.paged_decode_attention_mla(*args, pcfg=pcfg,
                                                        scale=scale)),
        plain_ms=time_ms(lambda: K.paged_decode_attention_mla_plain(
            *args, pcfg=pcfg, scale=scale), iters=5),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=time_ms(lib), shape=[b, h, rank, rope, int(tables.shape[1]), bs])


def serve_main_path(argv):
    """The user entry point at full width; returns the serving result,
    the launch counts of exactly this run, its wall time and the number
    of decode steps it ran."""
    from repro_torch.kernels import posit_codec as C
    from repro_torch.kernels import posit_paged_attn as K
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    decode_step = T._decode_step_paged
    steps = [0]

    def counted(*a, **kw):
        steps[0] += 1
        return decode_step(*a, **kw)

    counters = {**C.launches, **K.launches}
    for d in (C.launches, K.launches):
        for name in d:
            d[name] = 0
    torch.cuda.reset_peak_memory_stats()
    T._decode_step_paged = counted
    try:
        t0 = time.perf_counter()
        res = serve.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        T._decode_step_paged = decode_step
    counts = {**C.launches, **K.launches}
    assert set(counts) == set(counters)
    return res, counts, wall, steps[0]


def check_served(res):
    """Every request completed, every token in the vocabulary, no block
    leaked, and the block pool drained (under prefix caching, down to
    the blocks the prefix index holds)."""
    sched = res.sched
    vocab = sched.engine.cfg.vocab
    if len(res.done) != 16:
        fail(f"served {len(res.done)} of 16 requests")
    for c in res.done.values():
        if c.tokens.size == 0 or c.tokens.min() < 0 or c.tokens.max() >= vocab:
            fail(f"request {c.rid} produced out-of-vocabulary tokens")
    if sched.leak_report():
        fail(f"{len(sched.leak_report())} blocks leaked")
    held = len(sched.index) if sched.prefix_cache else 0
    if sched.pool.in_use != held:
        fail(f"{sched.pool.in_use - held} blocks still in use after the trace")


def report_served(name, res, counts, wall, steps):
    from repro_torch.compress import kvcache as kvc

    sched = res.sched
    st = sched.stats
    useful = sum(len(c.tokens) for c in res.done.values())
    arena = sum(sched.cache[k].numel() * sched.cache[k].element_size()
                for k in kvc.arena_leaves(sched.cache))
    peak_arena = arena * sched.pool.peak_in_use // sched.n_blocks
    print(f"main path {name}: full width, {len(res.done)} requests, "
          f"{useful} tokens in {res.seconds:.2f} s ({wall:.2f} s with init); "
          f"goodput {useful / max(sched.steps_run, 1):.3f} tok/step, "
          f"{useful / res.seconds:.2f} tok/s; step wall p50 "
          f"{st['step_wall_p50_ms']:.1f} ms p99 {st['step_wall_p99_ms']:.1f} ms "
          f"over {sched.n_chunks} rounds, {steps} decode steps; peak arena "
          f"bytes {peak_arena:,} of {arena:,}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if sched.prefix_cache:
        met, timed = res.deadlines_met or (0, 0)
        print(f"main path {name}: {sched.prefix_hits} prefix hits "
              f"({sched.prefix_matched_tokens} prompt tokens from cache), "
              f"{sched.n_cow} COW copies, {sched.n_evicted} evictions, "
              f"{sched.n_preempted} preemptions, deadlines met {met}/{timed}")
    print(f"main path {name} kernel launches: {counts}")


def check_fused_equals_gather(dev):
    """The repo's own invariant on a small input, on the card: the fused
    decode kernels and the gather path give the same greedy tokens, on
    the dense and MLA lanes."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.serve import drive_trace, poisson_trace
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.scheduler import Scheduler

    for arch in ("phi3-medium-14b", "minicpm3-4b"):
        cfg = dataclasses.replace(
            configs.get_config(arch).reduced(compute_dtype="float32"),
            kv_posit="posit16")
        params = T.init_params(cfg, seed=3, device=dev)
        trace = poisson_trace(np.random.default_rng(3), 6, 0.5, cfg.vocab,
                              24, 12)
        streams = []
        for kernel in ("fused", "gather"):
            eng = Engine(cfg, params, max_len=48, block_size=4,
                         decode_kernel=kernel, device=dev)
            done, order = drive_trace(Scheduler(eng, n_slots=3, chunk_size=4),
                                      trace)
            streams.append({order[r]: c.tokens.tolist() for r, c in done.items()})
        same = streams[0] == streams[1]
        print(f"small input (reduced {arch}, posit16 KV): fused == gather "
              f"tokens: {same}")
        if not same:
            fail(f"fused decode kernel and gather path disagree on the card "
                 f"({arch})")


def check_prefix_identity(dev):
    """On the card, reduced minicpm3 with f32 KV under the sanitizer:
    prefix caching changes no greedy token.  Exact duplicate prompts
    make admission copy blocks; freed blocks are poisoned."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.scheduler import Scheduler

    cfg = dataclasses.replace(
        configs.get_config("minicpm3-4b").reduced(compute_dtype="float32"))
    params = T.init_params(cfg, seed=5, device=dev)
    rng = np.random.default_rng(5)
    shared = rng.integers(1, cfg.vocab, 24).tolist()
    prompts = [shared, list(shared), list(shared) + [7, 9, 11],
               shared[:16] + rng.integers(1, cfg.vocab, 6).tolist()]
    streams, scheds = [], []
    for prefix in (False, True):
        eng = Engine(cfg, params, max_len=64, block_size=4, n_blocks=48,
                     sanitize=True, decode_kernel="fused", device=dev)
        sched = Scheduler(eng, n_slots=2, chunk_size=4, prefix_cache=prefix)
        rids = [sched.submit(prompts[0], 8)]
        done = sched.run(max_rounds=200)
        rids += [sched.submit(p, 8) for p in prompts[1:]]
        done.update(sched.run(max_rounds=200))
        streams.append([done[r].tokens.tolist() for r in rids])
        scheds.append(sched)
    s = scheds[1]
    same = streams[0] == streams[1]
    print(f"small input (reduced minicpm3-4b, f32 KV, sanitizer): prefix "
          f"cache == no prefix cache tokens: {same}; {s.prefix_hits} hits, "
          f"{s.n_cow} COW copies, {len(s.leak_report())} leaked blocks")
    if not same or s.prefix_hits == 0 or s.n_cow == 0 or s.leak_report():
        fail("prefix caching changed tokens or did not share on the card")


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
    rows.append(check_attention_mla(dev))
    for row in rows:
        print(f"{row['name']} at {row['shape']}: {row['ms']:.4f} ms "
              f"(bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
              f"plain {row['plain_ms']:.4f} ms, library "
              f"{row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 4)} ms)")

    by_path = {}
    for name, (argv, kernels) in MAIN_PATHS.items():
        res, counts, wall, steps = serve_main_path(argv)
        check_served(res)
        report_served(name, res, counts, wall, steps)
        for kernel in kernels:
            if counts[kernel] <= 0:
                fail(f"kernel {kernel} was not launched on the {name} path")
        if res.sched.prefix_cache and (res.sched.prefix_hits <= 0
                                       or res.sched.n_preempted <= 0):
            fail(f"the {name} path had no prefix hit or no preemption")
        n_layers = res.sched.engine.cfg.n_layers
        attn = kernels[-1]
        print(f"main path {name}: {attn} launches per decode step "
              f"{counts[attn] / max(steps, 1):.2f} ({n_layers} layers)")
        if counts[attn] != n_layers * steps:
            fail(f"{attn} ran {counts[attn]} times in {steps} decode steps "
                 f"of {n_layers} layers")
        by_path[name] = counts
        del res
        gc.collect()
        torch.cuda.empty_cache()
    for row in rows:
        row["launches_by_path"] = {p: c[row["name"]] for p, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())

    check_fused_equals_gather(dev)
    check_prefix_identity(dev)

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
