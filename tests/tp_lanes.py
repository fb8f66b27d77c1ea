"""Lanes of the tensor-parallel serving tests (a helper module, not a
test file): each lane's config overrides, engine and scheduler settings
and seeded trace, and one function that runs a lane on either package's
``Engine``/``Scheduler`` classes.  ``tests/test_torch_tp_serving.py``
runs the reference single-device on the JAX side and spawns gloo ranks
that import this module (it imports torch and ``repro_torch`` only) and
run :func:`rank_lanes`.

The first three lanes are the reference's own sharded-serving scripts
(``tests/test_sharded_serving.py``): the prefix-cache identity run and
the deadline preemption run with the gather path and the fused kernel.
The rest are the attention lanes at reduced size on the main path's
flags (posit16 KV, fused decode): dense GQA, the paged window, MLA, MQA,
MoE (an odd vocabulary, so the embedding and head replicate) and tied
embeddings (gemma-7b), and the unchunked paged scheduler on the window,
MLA, MQA and MoE lanes; ``CP_LANES``, context-parallel prefill at mp 4 on
the window lane and on MLA with 6 heads, chunked and unchunked, at
chunk and prompt lengths that 4 does not divide (:func:`cp_calls`
counts each call's gathers).  ``_linear_modes`` and :func:`serve_every_arch`
run the modes beside the paged schedulers under a mesh: the one-shot engine on a linear
and a paged cache, and ``serve --model-parallel 2``'s ranks on every
``ARCH_ID``.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

PHI3, MLA, MQA, MOE = "phi3-medium-14b", "minicpm3-4b", "granite-34b", "granite-moe-3b-a800m"
TIED = "gemma-7b"

_MAIN = dict(kv_posit="posit16")
LANES = {
    # the reference's identity script: 4 heads, 4 KV heads, prefix cache
    "identity": dict(arch=PHI3, cfg=dict(n_heads=4, n_kv_heads=4), trace="identity",
                     engine=dict(max_len=96, block_size=8, n_blocks=40),
                     sched=dict(n_slots=3, chunk_size=4, prefix_cache=True)),
    # the reference's preemption script, on the gather path and the fused kernel
    "preempt": dict(arch=PHI3, cfg=dict(n_heads=4, n_kv_heads=4), trace="preempt",
                    engine=dict(max_len=64, block_size=8, n_blocks=10),
                    sched=dict(n_slots=3, chunk_size=4, chunked_prefill=True)),
    "preempt-fused": dict(arch=PHI3, cfg=dict(n_heads=4, n_kv_heads=4), trace="preempt",
                          engine=dict(max_len=64, block_size=8, n_blocks=10,
                                      decode_kernel="fused"),
                          sched=dict(n_slots=3, chunk_size=4, chunked_prefill=True)),
    "dense": dict(arch=PHI3, cfg=_MAIN, trace="shared",
                  engine=dict(max_len=64, block_size=4, n_blocks=48, decode_kernel="fused"),
                  sched=dict(n_slots=3, chunk_size=4, prefix_cache=True)),
    "window": dict(arch=PHI3, cfg=dict(_MAIN, sliding_window=8, attn_chunk_kv=8),
                   trace="long", engine=dict(max_len=48, block_size=2, n_blocks=64,
                                             decode_kernel="fused"),
                   sched=dict(n_slots=3, chunk_size=4, chunked_prefill=True)),
    "mla": dict(arch=MLA, cfg=_MAIN, trace="shared",
                engine=dict(max_len=64, block_size=4, n_blocks=48, decode_kernel="fused"),
                sched=dict(n_slots=3, chunk_size=4, prefix_cache=True)),
    "mqa": dict(arch=MQA, cfg=_MAIN, trace="long",
                engine=dict(max_len=48, block_size=4, n_blocks=48, decode_kernel="fused"),
                sched=dict(n_slots=3, chunk_size=4, chunked_prefill=True)),
    "moe": dict(arch=MOE, cfg=dict(_MAIN, vocab=257), trace="long",
                engine=dict(max_len=48, block_size=4, n_blocks=48, decode_kernel="fused"),
                sched=dict(n_slots=3, chunk_size=4, chunked_prefill=True)),
    # tied embeddings: the head is the vocabulary-sharded embedding
    "tied": dict(arch=TIED, cfg=_MAIN, trace="long",
                 engine=dict(max_len=48, block_size=4, n_blocks=48, decode_kernel="fused"),
                 sched=dict(n_slots=3, chunk_size=4, chunked_prefill=True)),
}
for _lane in ("window", "mla", "mqa", "moe"):        # the unchunked paged scheduler
    LANES[f"{_lane}-unchunked"] = dict(
        LANES[_lane], trace="two-lengths", sched=dict(n_slots=3, chunk_size=4))
# context-parallel prefill at mp 4 (heads that do not split there): the
# window lane and MLA with 6 heads, on chunks of 3 and 6 rows and on the
# unchunked scheduler's prompts of 13 and 9, none a multiple of 4
LANES["cp-window"] = dict(LANES["window"], sched=dict(n_slots=3, chunk_size=3,
                                                      chunked_prefill=True))
LANES["cp-mla6"] = dict(LANES["mla"], cfg=dict(_MAIN, n_heads=6), trace="long",
                        sched=dict(n_slots=3, chunk_size=6, chunked_prefill=True))
for _lane in ("cp-window", "cp-mla6"):
    LANES[f"{_lane}-unchunked"] = dict(
        LANES[_lane], trace="two-lengths", sched=dict(n_slots=3, chunk_size=4))
CP_LANES = ("cp-window", "cp-mla6", "cp-window-unchunked", "cp-mla6-unchunked")
# sampling at a temperature: every rank must emit rank 0's draws
SAMPLED = dict(LANES["dense"], engine=dict(LANES["dense"]["engine"], temperature=0.7))


def param_key(lane: str) -> str:
    """Lanes that share this key share their weights."""
    spec = SAMPLED if lane == "sampled" else LANES[lane]
    shape = sorted((k, v) for k, v in spec["cfg"].items()
                   if k in ("n_heads", "n_kv_heads", "vocab"))
    return spec["arch"] + "".join(f",{k}={v}" for k, v in shape)


def lane_config(configs, lane: str):
    """The lane's reduced f32 config from either package's ``configs``."""
    spec = SAMPLED if lane == "sampled" else LANES[lane]
    cfg = configs.get_config(spec["arch"]).reduced(compute_dtype="float32")
    return dataclasses.replace(cfg, **spec["cfg"])


def _trace(name: str, vocab: int):
    """``(prompts, gens, deadlines, warm)``: the lane's seeded requests;
    the first ``warm`` are submitted, then two rounds run, then the rest
    (the preemption script's order); ``warm`` None submits all at once."""
    if name == "identity":
        rng = np.random.default_rng(0)
        prompts = [list(map(int, rng.integers(1, vocab, size=n)))
                   for n in (12, 9, 17, 5, 14, 11)]
        prompts[3] = prompts[2][:12] + prompts[3]     # shared prefix pair
        return prompts, [12] * 6, [None] * 6, None
    if name == "preempt":
        rng = np.random.default_rng(1)
        prompts = [list(map(int, rng.integers(1, vocab, size=n))) for n in (10, 8, 12)]
        return prompts, [16, 16, 8], [None, None, 20], 2
    rng = np.random.default_rng(2)
    if name == "shared":
        shared = list(map(int, rng.integers(1, vocab, size=9)))
        prompts = [shared + list(map(int, rng.integers(1, vocab, size=n)))
                   for n in (3, 6, 2, 5)]
        return prompts, [8, 6, 9, 7], [None] * 4, None
    if name == "two-lengths":          # the unchunked scheduler prefills per length
        prompts = [list(map(int, rng.integers(1, vocab, size=n))) for n in (13, 9, 13, 9)]
        return prompts, [9, 6, 8, 10], [None] * 4, None
    prompts = [list(map(int, rng.integers(1, vocab, size=n))) for n in (13, 7, 17, 10, 15)]
    return prompts, [9, 6, 8, 10, 7], [None] * 5, None


CP_CALLS = ("prefill", "prefill_chunk", "_decode_step_paged", "_decode_step_linear")


@contextlib.contextmanager
def cp_calls():
    """``{name: [gathers]}``: for each call of the transformer's whole-prompt
    prefill, prefill chunk and decode steps (``CP_CALLS``) under the
    block, the context-parallel gathers (``cp_prefill`` on the ``wire``
    counter) that it made."""
    from repro_torch.models import transformer as T
    from repro_torch.runtime import collectives as C

    key = ("model", "all_reduce", "cp_prefill", "float32")
    calls = {name: [] for name in CP_CALLS}
    saved = {name: getattr(T, name) for name in CP_CALLS}

    def counted(name, fn):
        def call(*args, **kw):
            before = C.wire.get(key, [0, 0])[0]
            out = fn(*args, **kw)
            calls[name].append(C.wire.get(key, [0, 0])[0] - before)
            return out
        return call

    for name, fn in saved.items():
        setattr(T, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(T, name, fn)


def run_lane(lane: str, cfg, params, Engine, Scheduler, spec=None, **engine_kw) -> dict:
    """Serve the lane's trace on ``Engine``/``Scheduler`` (either
    package's) under the sanitizer; returns its tokens, schedule and
    counters, and the scheduler as ``"sched"``."""
    spec = spec or LANES[lane]
    kw = dict(spec["engine"], **engine_kw)
    eng = Engine(cfg, params, paged=True, sanitize=True, **kw)
    sched = Scheduler(eng, **spec["sched"])
    prompts, gens, deadlines, warm = _trace(spec["trace"], cfg.vocab)
    warm = len(prompts) if warm is None else warm
    for p, g, d in zip(prompts[:warm], gens, deadlines):
        sched.submit(p, g, deadline=d)
    if warm < len(prompts):
        for _ in range(2):
            sched.step()
        for p, g, d in zip(prompts[warm:], gens[warm:], deadlines[warm:]):
            sched.submit(p, g, deadline=d)
    out = sched.run(max_rounds=500)
    st = sched.stats
    return {"tokens": {r: out[r].tokens.tolist() for r in sorted(out)},
            "finished": {r: out[r].finished_step for r in sorted(out)},
            "admitted": {r: out[r].admitted_step for r in sorted(out)},
            "prefix_hits": st["prefix_hits"], "n_preempted": sched.n_preempted,
            "n_leaked": st["n_leaked"], "sched": sched}


def rank_lanes(lanes, ref_params, model_parallel: int) -> dict:
    """One gloo rank: every lane of ``lanes`` on the port's engine with a
    ``model_parallel`` mesh, from the reference's parameters
    (``ref_params[param_key(lane)]``, nested dicts of numpy arrays); returns
    ``{lane: result}`` with each lane's ``cache_report`` and, under
    ``"_linear_modes"``, the one-shot tokens of the linear and the paged
    engine under the mesh and on this rank alone."""
    from repro_torch import configs
    from repro_torch.compress.kvcache import cache_report
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.scheduler import Scheduler
    from repro_torch.weights import params_from_jax

    mesh = make_host_mesh(model_parallel)
    out = {}
    for lane in lanes:
        spec = SAMPLED if lane == "sampled" else LANES[lane]
        cfg = lane_config(configs, lane)
        params = params_from_jax(ref_params[param_key(lane)], cfg, device="cpu")
        with cp_calls() as calls:
            res = run_lane(lane, cfg, params, Engine, Scheduler, spec=spec, device="cpu",
                           mesh=mesh)
        res["cp_calls"] = calls
        sched = res.pop("sched")
        eng = sched.engine
        res["report"] = cache_report(sched.cache, sched.pool, eng.cache_shards())
        res["local_heads"] = (eng.cfg.n_heads, eng.cfg.n_kv_heads)
        res["cp"] = bool(eng.tp.cp)
        res["leak_report"] = sorted(sched.leak_report())
        out[lane] = res
    out["_linear_modes"] = _linear_modes(Engine, cfg, params, mesh)
    return out


def _linear_modes(Engine, cfg, params, mesh) -> dict:
    """The one-shot ``generate`` on a linear and on a paged engine, under
    the mesh and without it (this rank alone, the whole weights): its
    tokens by ``(layout, sharded)``."""
    prompts = [[5, 3, 9, 2], [7, 1, 4]]
    return {(layout, m is not None): Engine(cfg, params, max_len=32, paged=layout == "paged",
                                            device="cpu", mesh=m).generate(prompts, 6)
            .tokens.tolist()
            for layout in ("linear", "paged") for m in (mesh, None)}


def serve_every_arch(argvs) -> list:
    """One gloo rank of ``serve --model-parallel 2`` on each of ``argvs``
    (``serve._serve_rank``, what ``main``'s ranks run): the one-shot
    tokens, or ``{rid: tokens}`` of a trace."""
    from repro_torch.launch import serve

    out = []
    for argv in argvs:
        res = serve._serve_rank(list(argv) + ["--model-parallel", "2"], ["cpu", "cpu"])
        out.append(res.tokens.tolist() if res.tokens is not None
                   else {r: c.tokens.tolist() for r, c in res.done.items()})
    return out


def fails_on_rank_1():
    """A rank function whose rank 1 raises while rank 0 waits in a
    collective."""
    import torch
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails")
    dist.all_reduce(torch.ones(2))
    return dist.get_rank()
