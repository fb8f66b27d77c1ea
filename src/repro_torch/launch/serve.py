"""Serving launcher: continuous batching over the paged posit KV cache.

Random-inits a model from a seed on ``--device`` (default ``cuda``),
builds a paged :class:`Engine` and a chunked-prefill
:class:`Scheduler`, and drives a simulated Poisson trace through it:
``--n-requests`` requests arrive at ``--arrival-rate`` expected arrivals
per decode step with ragged prompt and generation lengths, join free
slots of a ``--batch``-slot pool and leave as they finish.  Prompts flow
through the decode lane in ``--chunk-size``-token chunks.  The report
prints goodput, latency, cache bytes, the block-pool peak, step wall
times and the dispatch count.

  python -m repro_torch.launch.serve --arch phi3-medium-14b --batch 8 \\
      --n-requests 16 --prompt-len 512 --gen 32 --max-len 1024 \\
      --chunk-size 16 --block-size 16 --kv-posit posit16 \\
      --decode-kernel fused --device cuda

``--n-layers`` cuts depth only (every width stays the architecture's);
``--reduced`` swaps in the tiny same-family config for CPU runs
(``--device cpu``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import configs
from repro_torch.compress.kvcache import cache_report
from repro_torch.models import transformer as T
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import Scheduler


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


def drive_trace(sched: Scheduler, trace):
    """Feed an (arrival_step, prompt, gen) trace through a scheduler,
    advancing the simulation clock through idle gaps; returns
    ``({rid: Completion}, {rid: trace index})``."""
    pending = list(trace)
    done = {}
    order = {}
    while pending or sched.has_work:
        while pending and pending[0][0] <= sched.steps_run:
            _, prompt, gen = pending.pop(0)
            order[sched.submit(prompt, gen)] = len(order)
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


def run_continuous(args, cfg, params) -> ServeResult:
    rng = np.random.default_rng(args.seed)
    max_len = args.max_len or (args.prompt_len + args.gen - 1 +
                               args.chunk_size)
    engine = Engine(cfg, params, max_len=max_len,
                    temperature=args.temperature, seed=args.seed,
                    block_size=args.block_size, n_blocks=args.n_blocks,
                    decode_kernel=args.decode_kernel, device=args.device)
    sched = Scheduler(engine, n_slots=args.batch, chunk_size=args.chunk_size,
                      chunked_prefill=True)
    trace = poisson_trace(rng, args.n_requests, args.arrival_rate,
                          cfg.vocab, args.prompt_len, args.gen)
    t0 = time.perf_counter()
    done, _ = drive_trace(sched, trace)
    dt = time.perf_counter() - t0
    rep = cache_report(sched.cache, sched.pool)

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
    print(f"  paged: {sched.n_blocks} arena blocks x {sched.block_size} "
          f"slots (dense worst case {args.batch * sched.table_width}); "
          f"peak in use {sched.pool.peak_in_use}, peak committed "
          f"{sched.peak_committed}")
    print(f"  step wall p50 {st['step_wall_p50_ms']:.1f} ms p99 "
          f"{st['step_wall_p99_ms']:.1f} ms over {sched.n_chunks} rounds "
          f"(device {engine.device})")
    print(f"  chunked prefill: {sched.prefill_tokens} prompt tokens "
          f"through the decode lane in {args.chunk_size}-token chunks; "
          f"{engine.n_compiles} dispatch shapes (flat across prompt "
          f"lengths)")
    return ServeResult(done=done, sched=sched, seconds=dt)


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
                    help="slot-pool width")
    ap.add_argument("--n-requests", type=int, default=16)
    ap.add_argument("--arrival-rate", type=float, default=0.2,
                    help="expected request arrivals per decode step")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="longest prompt (lengths are uniform in "
                         "[prompt-len/2, prompt-len])")
    ap.add_argument("--gen", type=int, default=16,
                    help="longest generation (uniform in [gen/4, gen])")
    ap.add_argument("--max-len", type=int, default=0,
                    help="per-row cache budget (default prompt-len + gen "
                         "- 1 + chunk-size)")
    ap.add_argument("--chunk-size", type=int, default=8,
                    help="prefill chunk width and decode steps per round")
    ap.add_argument("--block-size", type=int, default=16,
                    help="cache slots per arena block")
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="arena size in blocks (0 = worst case)")
    ap.add_argument("--kv-posit", choices=["posit16", "posit8", "none"],
                    default="posit16")
    ap.add_argument("--decode-kernel", choices=["gather", "fused"],
                    default="fused",
                    help="paged decode attention: the fused CUDA table "
                         "walk or the plain gather path")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 = softmax sampling")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights, the trace and the sampler")
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


def main(argv=None) -> ServeResult:
    args = build_parser().parse_args(argv)
    cfg = model_config(args)
    params = T.init_params(cfg, seed=args.seed, device=args.device)
    return run_continuous(args, cfg, params)


if __name__ == "__main__":
    main()
