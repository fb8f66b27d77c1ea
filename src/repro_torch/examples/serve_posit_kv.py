"""Serve a small model with batched requests + posit KV cache.

The port of the reference's ``examples/serve_posit_kv.py``: the
preallocated-cache serving engine generates greedily twice -- once with
an f32 cache, once with the paper's posit16 cache (the codec's quantize
at prefill, ``csrc/posit_codec.cu``; each decode token's fused
quantize-and-write, ``csrc/posit_paged_write.cu``; the codec's
dequantize of the cache at each decode step) -- and reports the byte
saving and the agreement of the generated tokens.  Every decode token
lands in preallocated headroom, never on the last slot.

The second half A/Bs the two cache LAYOUTS on the posit16 engine: the
dense ``batch x max_len`` preallocation versus the paged block-table
arena (``Engine(paged=True)``), which must produce identical tokens
while only allocating the blocks the ragged prompts actually touch.

  PYTHONPATH=src python -m repro_torch.examples.serve_posit_kv [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch import configs
from repro_torch.compress.kvcache import cache_report
from repro_torch.device import resolve_device
from repro_torch.models import get_family
from repro_torch.runtime.engine import Engine

PROMPT_LEN, GEN = 24, 16


def generate(cfg, params, prompts, n_steps, dev, **engine_kw):
    engine = Engine(cfg, params, max_len=PROMPT_LEN + GEN, seed=0, device=dev,
                    **engine_kw)
    res = engine.generate(prompts, n_steps)
    return res.tokens, res.cache, engine


def run(device="cuda") -> dict:
    dev = resolve_device(device)
    base = configs.get_config("phi3-medium-14b").reduced(compute_dtype="float32")
    params = get_family(base).init_params(base, seed=0, device=dev)
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, base.vocab, (4, PROMPT_LEN))

    gen_f32, cache_f32, _ = generate(base, params, prompts, GEN, dev)
    cfg_q = dataclasses.replace(base, kv_posit="posit16")
    gen_q, cache_q, _ = generate(cfg_q, params, prompts, GEN, dev)

    # dense vs paged layout on ragged prompts: identical tokens, fewer
    # blocks resident than the dense worst case
    ragged = [rng.integers(1, base.vocab, n).tolist()
              for n in (PROMPT_LEN, PROMPT_LEN // 2, PROMPT_LEN // 3, 8)]
    dense_toks, dense_cache, _ = generate(cfg_q, params, ragged, GEN, dev)
    paged_toks, paged_cache, eng = generate(cfg_q, params, ragged, GEN, dev,
                                            paged=True, block_size=8)
    return dict(gen_f32=gen_f32, gen_q=gen_q,
                agree=float((gen_f32 == gen_q).mean()),
                rep_f32=cache_report(cache_f32), rep_q=cache_report(cache_q),
                rep_dense=cache_report(dense_cache), rep_paged=cache_report(paged_cache),
                paged_identical=bool((dense_toks == paged_toks).all()),
                peak_blocks=eng.pool.peak_in_use, n_blocks=eng.pool.n_blocks)


def check(res: dict) -> None:
    assert res["agree"] > 0.9, "posit16 KV cache changed generations materially"
    assert res["paged_identical"], "paged cache layout changed the generated tokens"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    f32, q = res["rep_f32"]["bytes"], res["rep_q"]["bytes"]
    print(f"batched serve: 4 requests x {PROMPT_LEN}-token prompts, "
          f"+{GEN} decodes (preallocated max_len={PROMPT_LEN + GEN})")
    print(f"cache bytes  f32:     {f32:,}")
    print(f"cache bytes  posit16: {q:,} ({f32 / q:.2f}x smaller)")
    print(f"greedy tokens agree:  {100 * res['agree']:.1f}%")
    print("f32 cache sample   :", res["gen_f32"][0][:10])
    print("posit16 cache sample:", res["gen_q"][0][:10])
    print(f"paged layout (block_size=8): tokens identical = {res['paged_identical']}")
    print(f"blocks in use: {res['peak_blocks']} of {res['n_blocks']} worst-case "
          f"({res['rep_paged']['bytes']:,} B arena vs {res['rep_dense']['bytes']:,} B dense)")
    check(res)
    print("OK")


if __name__ == "__main__":
    main()
