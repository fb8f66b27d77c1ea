"""Serving launcher: the preallocated posit-KV engine and the
continuous-batching scheduler.

Random-inits a model from a seed on ``--device`` (default ``cuda``).
The command line is the reference's (``repro.launch.serve``), defaults
included (``--kv-posit none``, ``--decode-kernel gather``), and every
mode of it runs.

Without ``--continuous`` (the one-shot engine): a ``--batch`` of prompts
(``--ragged`` draws their lengths from ``[prompt-len/2, prompt-len]``)
is prefilled whole, the cache report printed, then ``Engine.generate``
decodes ``--gen`` tokens; ``main`` returns the (B, gen) token array.
``--paged`` takes the block-table cache:

  python -m repro_torch.launch.serve --arch phi3-medium-14b --batch 8 \\
      --prompt-len 512 --ragged --gen 32 --max-len 1024 --kv-posit posit16 \\
      --device cuda

``--continuous`` drives a simulated Poisson trace through the
scheduler: ``--n-requests`` requests arrive at ``--arrival-rate``
expected arrivals per decode step with ragged prompt and generation
lengths, join free slots of a ``--batch``-slot pool and leave as they
finish, ``--chunk-size`` decode steps a round.  Alone it runs the
dense-cache scheduler (a shared frontier, compaction); ``--paged`` the
block-table one; ``--chunked-prefill`` (with ``--paged``) sends prompts
through the decode lane in ``--chunk-size``-token chunks.  The report
prints goodput, latency, cache bytes, the block-pool peak, step wall
times and the dispatch count:

  python -m repro_torch.launch.serve --arch phi3-medium-14b --continuous \\
      --paged --chunked-prefill --batch 8 --n-requests 16 --prompt-len 512 \\
      --gen 32 --max-len 1024 --chunk-size 16 --block-size 16 \\
      --kv-posit posit16 --decode-kernel fused --device cuda

``--prefix-cache`` shares prompt prefixes through copy-on-write block
tables; ``--prefix-share`` draws the matching trace, whose prompts open
with one common system prefix of that fraction of ``--prompt-len``.
``--deadline-ms`` gives requests a completion deadline, converted to
the decode-step clock at ``MS_PER_STEP``: admission turns
earliest-deadline-first and a request that cannot get blocks preempts
the row with the latest deadline.  ``--deadline-share`` gives the
deadline to that seeded fraction of the requests only and leaves the
rest best-effort (interactive and batch traffic on one pool; with a
deadline on every request arrival order is deadline order, so nothing
is ever preempted):

  python -m repro_torch.launch.serve --arch minicpm3-4b --continuous \\
      --paged --chunked-prefill --batch 8 --n-requests 16 --prompt-len 512 \\
      --gen 32 --max-len 1024 --chunk-size 16 --block-size 16 \\
      --kv-posit posit16 --decode-kernel fused --prefix-cache \\
      --prefix-share 0.5 --deadline-ms 5000 --deadline-share 0.25 \\
      --n-blocks 200 --device cuda

The port's own flags: ``--n-layers`` cuts depth only (every width stays
the architecture's), ``--deadline-share`` as above, and ``--device``.
``--reduced`` swaps in the tiny same-family config for CPU runs
(``--device cpu``).  ``--arch`` takes every architecture of
``configs.ARCH_IDS``, its parameters from its family's ``init_params``
(``models.registry``).  The one-shot path serves every family: on
whisper-tiny it draws the encoder frames (batch, ``encoder_seq``,
``d_model``) from the seeded stream after the prompts, and on
internvl2-1b the visual prefix after them, as the reference does:

  python -m repro_torch.launch.serve --arch whisper-tiny --batch 8 \\
      --prompt-len 384 --gen 32 --max-len 448 --kv-posit posit16 \\
      --device cuda

``--continuous`` and ``--paged`` need the transformer family and raise
``ValueError`` on the others, as the reference's do.

``--model-parallel N`` serves tensor-parallel on N ranks, one process
each (``launch/mesh.py``), in every mode and family the single device
serves: every rank draws the weights from the same seed and keeps its
shard of each layer (``runtime/sharding.py``), holds its share of the
cache's KV and state heads, and runs the same engine or scheduler; rank
0 prints the report with a ``sharded:`` line (KV bytes per device of
the total, the walls).  The one-shot ``main`` returns rank 0's tokens
after checking that every rank's are identical.  ``--rank-devices``
lists the ranks' devices, by default one card a rank (NCCL), or N CPU
ranks with ``--device cpu`` (gloo); ranks that share a card, e.g.
``--rank-devices cuda:0,cuda:0``, talk over gloo:

  python -m repro_torch.launch.serve --continuous --paged \\
      --chunked-prefill --kv-posit posit16 --decode-kernel fused \\
      --prefix-cache --model-parallel 2 --reduced --device cpu
  python -m repro_torch.launch.serve --arch rwkv6-7b --prompt-len 16 \\
      --model-parallel 2 --reduced --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import sys
import time

import numpy as np

import torch

from repro_torch import configs
from repro_torch.compress.kvcache import cache_report
from repro_torch.models.registry import get_family
from repro_torch.runtime.engine import Engine, GenerationResult
from repro_torch.runtime.scheduler import Scheduler

# assumed wall time of one decode step, used only to convert
# --deadline-ms into the decode-step simulation clock (the schedule is
# simulated, so only the ratio deadline / step matters)
MS_PER_STEP = 10.0


def poisson_trace(rng, n_requests, rate, vocab, prompt_len, gen):
    """Ragged request trace: Poisson arrivals (``rate`` expected requests
    per decode step), uniform prompt/generation lengths."""
    arrivals = np.cumsum(rng.exponential(1.0 / max(rate, 1e-9),
                                         size=n_requests))
    out = []
    for t in arrivals:
        plen = int(rng.integers(max(2, prompt_len // 2), prompt_len + 1))
        g = int(rng.integers(max(2, gen // 4), gen + 1))
        out.append((float(t), rng.integers(1, vocab, plen).tolist(), g))
    return out


def shared_prefix_trace(rng, n_requests, rate, vocab, prompt_len, gen,
                        share: float = 0.75):
    """Request trace whose prompts all open with the same system prefix
    of ``share * prompt_len`` tokens, drawn once, and a per-request tail;
    arrivals and generation lengths follow :func:`poisson_trace`."""
    arrivals = np.cumsum(rng.exponential(1.0 / max(rate, 1e-9),
                                         size=n_requests))
    n_shared = max(1, int(prompt_len * share))
    prefix = rng.integers(1, vocab, n_shared).tolist()
    out = []
    for t in arrivals:
        tail = int(rng.integers(2, max(3, prompt_len - n_shared + 1)))
        g = int(rng.integers(max(2, gen // 4), gen + 1))
        out.append((float(t),
                    prefix + rng.integers(1, vocab, tail).tolist(), g))
    return out


def drive_trace(sched: Scheduler, trace, deadline_steps=None):
    """Feed an (arrival_step, prompt, gen) trace through a scheduler,
    advancing the simulation clock through idle gaps; returns
    ``({rid: Completion}, {rid: trace index})``.  ``deadline_steps``,
    one entry per trace entry, gives that request the absolute deadline
    ``arrival + deadline_steps[i]``; ``None`` (for the whole trace or one
    entry) leaves it best-effort."""
    pending = list(trace)
    done = {}
    order = {}
    while pending or sched.has_work:
        while pending and pending[0][0] <= sched.steps_run:
            t, prompt, gen = pending.pop(0)
            d = None if deadline_steps is None else deadline_steps[len(order)]
            rid = sched.submit(
                prompt, gen,
                deadline=None if d is None else int(np.ceil(t)) + int(d))
            order[rid] = len(order)
        if not sched.has_work:
            # idle: jump the decode-step clock to the next arrival
            sched.steps_run = max(sched.steps_run,
                                  int(np.ceil(pending[0][0])))
            continue
        for c in sched.step():
            done[c.rid] = c
    return done, order


@dataclasses.dataclass
class ServeResult:
    done: dict            # rid -> Completion
    sched: Scheduler
    seconds: float        # wall time of the whole trace
    deadlines_met: tuple = None   # (met, requests with a deadline)


@dataclasses.dataclass
class RankResult:
    """One rank's run of a tensor-parallel trace or one-shot batch
    (picklable)."""
    done: dict            # rid -> Completion ({} one-shot)
    stats: dict           # Scheduler.stats ({} one-shot)
    report: dict          # cache_report: bytes of the whole cache, per_device_bytes this rank's
    launches: dict        # kernel launches of this rank's run
    seconds: float        # wall time of the whole trace (one-shot: generate)
    tokens: np.ndarray = None     # one-shot: the (B, gen) tokens
    prefill_seconds: float = 0.0  # one-shot: the reported prefill


@dataclasses.dataclass
class ShardedServeResult:
    """``--model-parallel`` > 1: every rank's result, rank 0 first."""
    ranks: list           # RankResult per rank
    mesh: dict            # {"data": n, "model": mp}
    backend: str          # the process group's backend


@dataclasses.dataclass
class OneShotResult:
    result: GenerationResult  # its (B, gen) tokens are what ``main`` returns
    engine: Engine
    prompts: list             # the batch as given to the engine
    prefill_seconds: float    # the reported prefill alone
    seconds: float            # generate: prefill and every decode step
    inputs: dict = dataclasses.field(default_factory=dict)   # ``frames``/``visual``
    report: dict = None       # cache_report of the reported prefill's cache


def _build_engine(args, cfg, params, max_len, mesh=None):
    return Engine(cfg, params, max_len=max_len,
                  temperature=args.temperature, seed=args.seed,
                  paged=args.paged, block_size=args.block_size,
                  n_blocks=args.n_blocks,
                  decode_kernel=None if args.decode_kernel == "gather"
                  else args.decode_kernel, device=args.device, mesh=mesh)


def run_oneshot(args, cfg, params, mesh=None) -> OneShotResult:
    """Prefill a batch of prompts (the cache report), then generate."""
    rng = np.random.default_rng(args.seed)
    if args.ragged:
        lens = rng.integers(max(2, args.prompt_len // 2), args.prompt_len + 1,
                            size=args.batch)
        prompts = [rng.integers(1, cfg.vocab, int(n)).tolist() for n in lens]
    else:
        prompts = rng.integers(1, cfg.vocab, size=(args.batch, args.prompt_len))
    kwargs = {}
    if cfg.family == "whisper":       # drawn after the prompts, as the reference
        kwargs["frames"] = torch.as_tensor(rng.standard_normal(
            (args.batch, cfg.encoder_seq, cfg.d_model)), dtype=torch.float32,
            device=args.device)
    if cfg.n_visual_tokens:
        kwargs["visual"] = torch.as_tensor(rng.standard_normal(
            (args.batch, cfg.n_visual_tokens, cfg.d_model)), dtype=torch.float32,
            device=args.device)
    max_len = args.max_len or (args.prompt_len + args.gen)
    engine = _build_engine(args, cfg, params, max_len, mesh)

    t0 = time.perf_counter()
    cache, _, lens = engine.prefill(prompts, reserve_tokens=args.gen - 1, **kwargs)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    rep = cache_report(cache, None, engine.cache_shards())
    del cache
    print(f"prefill: {args.batch} prompts (lens {lens.tolist()}) in "
          f"{t_prefill:.2f}s; cache bytes = {rep['bytes']:,} of "
          f"{rep['f32_bytes']:,} f32-equiv ({rep['ratio']:.2f}x, "
          f"kv_posit={cfg.kv_posit}, max_len={max_len})")
    if engine.tp is not None:
        print(_sharded_line(engine, rep, f"prefill {t_prefill:.2f}s"))
    t0 = time.perf_counter()
    res = engine.generate(prompts, args.gen, **kwargs)
    dt = time.perf_counter() - t0
    print(f"decode: {args.gen} steps in {dt:.2f}s "
          f"({args.gen * args.batch / max(dt, 1e-9):.1f} tok/s, prefill "
          f"included; device {engine.device})")
    print("generated ids:\n", res.tokens)
    return OneShotResult(result=res, engine=engine, prompts=prompts,
                         prefill_seconds=t_prefill, seconds=dt, inputs=kwargs, report=rep)


def _sharded_line(engine, rep, walls: str) -> str:
    """The report's ``sharded:`` line of a tensor-parallel engine."""
    import torch.distributed as dist

    return (f"  sharded: mesh {dict(zip(engine.mesh.mesh_dim_names, engine.mesh.shape))}; "
            f"KV per device {rep['per_device_bytes']:,} of {rep['bytes']:,} bytes "
            f"(model_parallel={engine.tp.size}, {dist.get_backend()}); {walls}")


def run_continuous(args, cfg, params, mesh=None) -> ServeResult:
    rng = np.random.default_rng(args.seed)
    max_len = args.max_len or (args.prompt_len + args.gen - 1 +
                               args.chunk_size)
    engine = _build_engine(args, cfg, params, max_len, mesh)
    sched = Scheduler(engine, n_slots=args.batch, chunk_size=args.chunk_size,
                      prefix_cache=args.prefix_cache,
                      chunked_prefill=args.chunked_prefill)
    if args.prefix_share > 0:
        trace = shared_prefix_trace(rng, args.n_requests, args.arrival_rate,
                                    cfg.vocab, args.prompt_len, args.gen,
                                    share=args.prefix_share)
    else:
        trace = poisson_trace(rng, args.n_requests, args.arrival_rate,
                              cfg.vocab, args.prompt_len, args.gen)
    deadlines, met_of = None, None
    if args.deadline_ms > 0:
        steps = max(1, int(np.ceil(args.deadline_ms / MS_PER_STEP)))
        deadlines = [steps] * len(trace)
        if args.deadline_share < 1.0:
            deadlines = [steps if u < args.deadline_share else None
                         for u in rng.random(len(trace))]
    t0 = time.perf_counter()
    done, order = drive_trace(sched, trace, deadline_steps=deadlines)
    dt = time.perf_counter() - t0
    rep = cache_report(sched.cache, sched.pool if sched.paged else None,
                       engine.cache_shards())

    useful = sum(len(c.tokens) for c in done.values())
    lat = np.array(sorted(c.latency_steps for c in done.values()))
    goodput = useful / max(sched.steps_run, 1)
    st = sched.stats
    print(f"continuous: {len(done)} requests, {useful} tokens in "
          f"{sched.n_chunks} chunks ({sched.steps_run} decode steps, "
          f"{dt:.2f}s)")
    print(f"  goodput {goodput:.2f} tok/step of a {args.batch}-slot pool "
          f"({useful / max(dt, 1e-9):.1f} tok/s wall); latency p50 "
          f"{np.percentile(lat, 50):.0f} p99 {np.percentile(lat, 99):.0f} "
          f"steps")
    print(f"  cache: {rep['bytes']:,} bytes of {rep['f32_bytes']:,} "
          f"f32-equiv ({rep['ratio']:.2f}x, kv_posit={cfg.kv_posit}, "
          f"max_len={max_len})")
    if sched.paged:
        print(f"  paged: {sched.n_blocks} arena blocks x {sched.block_size} "
              f"slots (dense worst case {args.batch * sched.table_width}); "
              f"peak in use {sched.pool.peak_in_use}, peak committed "
              f"{sched.peak_committed}")
    print(f"  step wall p50 {st['step_wall_p50_ms']:.1f} ms p99 "
          f"{st['step_wall_p99_ms']:.1f} ms over {sched.n_chunks} rounds "
          f"(device {engine.device})")
    if engine.tp is not None:
        print(_sharded_line(engine, rep, f"step wall p50 {st['step_wall_p50_ms']:.1f} ms "
                                         f"p99 {st['step_wall_p99_ms']:.1f} ms"))
    if sched.chunked:
        print(f"  chunked prefill: {sched.prefill_tokens} prompt tokens "
              f"through the decode lane in {args.chunk_size}-token chunks; "
              f"{engine.n_compiles} dispatch shapes (flat across prompt "
              f"lengths)")
    else:
        print(f"  whole-prompt prefill: {sched.prefill_tokens} prompt tokens "
              f"at admission; {engine.n_compiles} dispatch shapes (one per "
              f"prompt length)")
    if deadlines is not None:
        timed = [(c, deadlines[order[r]]) for r, c in done.items()
                 if deadlines[order[r]] is not None]
        met = sum(1 for c, d in timed if c.finished_step <= c.arrival_step + d)
        met_of = (met, len(timed))
        print(f"  deadlines: {args.deadline_ms:.0f} ms ({steps} steps at "
              f"{MS_PER_STEP:.0f} ms/step) on {len(timed)}/{len(done)} "
              f"requests; {met}/{len(timed)} met, {sched.n_preempted} "
              f"preemptions")
    if args.prefix_cache:
        print(f"  prefix cache: {sched.prefix_hits}/{sched.n_admitted} "
              f"admissions hit, {sched.prefix_matched_tokens} prompt tokens "
              f"served from cache ({sched.prefill_tokens} prefilled), "
              f"{sched.n_cow} COW copies, {sched.n_evicted} evictions; peak "
              f"committed physical {sched.peak_committed} vs logical "
              f"{sched.peak_logical} blocks")
    return ServeResult(done=done, sched=sched, seconds=dt,
                       deadlines_met=met_of)


def _serving_launches() -> dict:
    from repro_torch.kernels import posit_codec, posit_paged_attn
    return {**posit_codec.launches, **posit_paged_attn.launches}


def rank_model(argv, devices):
    """In a rank of ``--model-parallel`` over ``devices``: the parsed
    ``argv`` (its device the rank's), the mesh, the config and this
    rank's shard of the seeded weights, drawn a layer at a time; returns
    ``(args, mesh, cfg, params)``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import sharding

    args = build_parser().parse_args(argv)
    args.device = devices[dist.get_rank()]
    mesh = make_host_mesh(args.model_parallel, torch.device(args.device).type)
    cfg = model_config(args)
    params = get_family(cfg).init_params(
        cfg, seed=args.seed, device=args.device,
        shard=lambda t, prefix: sharding.shard_params(t, mesh, cfg, prefix))
    return args, mesh, cfg, params


def _serve_rank(argv, devices) -> RankResult:
    """One rank of ``--model-parallel``: its shard of the model, the
    trace or the one-shot batch; only rank 0 prints."""
    return serve_on_rank(*rank_model(argv, devices))


def serve_on_rank(args, mesh, cfg, params) -> RankResult:
    """The trace or the one-shot batch of ``args`` on this rank's shard
    ``params`` (:func:`rank_model`); only rank 0 prints."""
    import torch.distributed as dist

    quiet = contextlib.redirect_stdout(io.StringIO()) if dist.get_rank() \
        else contextlib.nullcontext()
    with quiet:
        before = _serving_launches()
        if not args.continuous:
            res = run_oneshot(args, cfg, params, mesh)
            after = _serving_launches()
            return RankResult(done={}, stats={}, report=res.report,
                              launches={k: after[k] - before[k] for k in after},
                              seconds=res.seconds, tokens=res.result.tokens,
                              prefill_seconds=res.prefill_seconds)
        res = run_continuous(args, cfg, params, mesh)
        after = _serving_launches()
        sched = res.sched
        rep = cache_report(sched.cache, sched.pool if sched.paged else None,
                           sched.engine.cache_shards())
    return RankResult(done=res.done, stats=sched.stats, report=rep,
                      launches={k: after[k] - before[k] for k in after},
                      seconds=res.seconds)


def sharded_tokens(res: ShardedServeResult) -> np.ndarray:
    """A sharded one-shot run's (B, gen) tokens: rank 0's, after checking
    that every rank's are identical."""
    toks = res.ranks[0].tokens
    for r, rank in enumerate(res.ranks):
        if not np.array_equal(rank.tokens, toks):
            raise RuntimeError(f"tensor-parallel rank {r}'s tokens differ from rank 0's")
    return toks


def run_sharded(args, argv, timeout: float | None = None) -> ShardedServeResult:
    """``--model-parallel`` > 1: spawn the ranks and join them (with no
    deadline on the whole run unless ``timeout`` seconds are given: a
    hung collective fails its rank at ``mesh.COLLECTIVE_TIMEOUT``)."""
    from repro_torch.launch import mesh as M

    n = args.model_parallel
    devices = args.rank_devices.split(",") if args.rank_devices \
        else M.default_devices(n, args.device)
    if len(devices) != n:
        raise ValueError(f"--rank-devices names {len(devices)} devices for "
                         f"--model-parallel {n}")
    cpu = all(torch.device(d).type == "cpu" for d in devices)
    ranks = M.spawn(_serve_rank, devices, (list(argv), devices), timeout=timeout,
                    threads=max(1, torch.get_num_threads() // n) if cpu else 0)
    return ShardedServeResult(ranks=ranks, mesh={"data": 1, "model": n},
                              backend=M.backend_for(devices))


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=configs.ARCH_IDS,
                    default="phi3-medium-14b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU runs)")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut depth to this many layers (0 = the "
                         "architecture's); widths are never cut")
    ap.add_argument("--batch", type=int, default=4,
                    help="prompts of the one-shot batch, or the slot-pool "
                         "width with --continuous")
    ap.add_argument("--n-requests", type=int, default=16)
    ap.add_argument("--arrival-rate", type=float, default=0.2,
                    help="expected request arrivals per decode step")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="prompt length (the longest with --ragged or "
                         "--continuous: lengths uniform in "
                         "[prompt-len/2, prompt-len])")
    ap.add_argument("--ragged", action="store_true",
                    help="one-shot: vary the prompt lengths across the batch")
    ap.add_argument("--gen", type=int, default=16,
                    help="longest generation (uniform in [gen/4, gen])")
    ap.add_argument("--max-len", type=int, default=0,
                    help="per-row cache budget (default prompt-len + gen; "
                         "with --continuous prompt-len + gen - 1 + "
                         "chunk-size)")
    ap.add_argument("--chunk-size", type=int, default=8,
                    help="prefill chunk width and decode steps per round")
    ap.add_argument("--block-size", type=int, default=16,
                    help="cache slots per arena block")
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="arena size in blocks (0 = worst case)")
    ap.add_argument("--kv-posit", choices=["posit16", "posit8", "none"],
                    default="none")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching on a simulated Poisson trace")
    ap.add_argument("--paged", action="store_true",
                    help="paged block-table KV cache (omit for the dense "
                         "layout)")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="prompts through the decode lane in chunk-size "
                         "chunks (with --continuous --paged; implied by "
                         "--prefix-cache)")
    ap.add_argument("--decode-kernel", choices=["gather", "fused"],
                    default="gather",
                    help="paged decode attention: the fused CUDA table "
                         "walk or the plain gather path")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share prompt prefixes through copy-on-write "
                         "block tables; greedy token streams are "
                         "unchanged")
    ap.add_argument("--prefix-share", type=float, default=0.0,
                    help="fraction of each prompt drawn from one shared "
                         "system prefix (0 = independent Poisson prompts)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request completion deadline in ms, at "
                         "MS_PER_STEP ms per decode step; drives EDF "
                         "admission and preemption by block release "
                         "(0 = best-effort FIFO)")
    ap.add_argument("--deadline-share", type=float, default=1.0,
                    help="fraction of requests, drawn from the seed, that "
                         "carry --deadline-ms; the rest are best-effort")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 = softmax sampling")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights, the trace and the sampler")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor-parallel degree over a mesh of ranks: "
                         "weights shard by the runtime/sharding rule table "
                         "and the KV caches (paged or linear) and recurrent "
                         "states shard their head axis over 'model', so "
                         "per-device KV bytes drop ~linearly; token streams "
                         "are identical to the single-device run (one "
                         "process a rank; every mode and family)")
    ap.add_argument("--rank-devices", default="",
                    help="with --model-parallel: the ranks' devices, comma "
                         "separated (default: one card a rank, or the CPU "
                         "with --device cpu); ranks sharing a card use gloo")
    ap.add_argument("--device", default="cuda")
    return ap


def model_config(args):
    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(compute_dtype="float32")
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    return dataclasses.replace(
        cfg, kv_posit=None if args.kv_posit == "none" else args.kv_posit)


def check_mode(ap, args) -> None:
    """The reference's own refusals (``ap.error``, exit status 2)."""
    if args.prefix_cache and not (args.continuous and args.paged):
        ap.error("--prefix-cache requires --continuous --paged")
    if args.chunked_prefill and not (args.continuous and args.paged):
        ap.error("--chunked-prefill requires --continuous --paged")
    if args.deadline_ms > 0 and not args.continuous:
        ap.error("--deadline-ms requires --continuous")
    if args.decode_kernel == "fused" and not args.paged:
        ap.error("--decode-kernel fused requires --paged")


def main(argv=None):
    """Run the command line; returns the one-shot path's (B, gen) token
    array, as the reference's ``main`` does (with ``--model-parallel`` >
    1 rank 0's, every rank's checked identical), or the continuous run's
    :class:`ServeResult` (with ``--model-parallel`` > 1 a
    :class:`ShardedServeResult`)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    check_mode(ap, args)
    cfg = model_config(args)
    if args.model_parallel > 1:
        if (args.continuous or args.paged) and cfg.family != "transformer":
            # what every rank's engine or scheduler would raise, raised once
            raise ValueError(
                "--continuous and --paged need the transformer family's per-row "
                f"decode positions (got family={cfg.family!r})")
        res = run_sharded(args, sys.argv[1:] if argv is None else argv)
        return res if args.continuous else sharded_tokens(res)
    params = get_family(cfg).init_params(cfg, seed=args.seed, device=args.device)
    if args.continuous:
        return run_continuous(args, cfg, params)
    return run_oneshot(args, cfg, params).result.tokens


if __name__ == "__main__":
    main()
