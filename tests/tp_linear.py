"""Lanes of the tensor-parallel tests of the linear-cache modes and of
hymba, rwkv6 and whisper (a helper module, not a test file).

``tests/test_torch_tp_linear.py`` and ``tests/test_torch_tp_families.py``
run the reference single-device on the JAX side and spawn gloo ranks
(``launch/mesh.spawn``) that import this module (torch and
``repro_torch`` only) and run :func:`rank_run`: the one-shot engine
(``generate`` and ``generate_stepwise``) on each lane of ``ONESHOT``,
the dense-cache scheduler on each lane of ``DENSE``, the sampled lane,
the split norms, the checkpoint's round trip of every leaf and rwkv6's
bf16 logits (``DRIFT``).

Reduced configs in f32 with posit16 KV.  The reference's initial biases,
norm scales and per-head vectors are zeros or ones, under which a bias
added on every rank before the sum, or a per-head vector sliced to the
wrong heads, gives the right answer; :func:`perturb` draws them from a
seed instead, for both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

PHI3, MLA, MQA, MOE = "phi3-medium-14b", "minicpm3-4b", "granite-34b", "granite-moe-3b-a800m"
_KV = dict(kv_posit="posit16")
# one-shot lanes: the transformer's attention lanes, then the other families
ONESHOT = {
    "dense": dict(arch=PHI3, cfg=_KV),
    "window": dict(arch=PHI3, cfg=dict(_KV, sliding_window=8, attn_chunk_kv=8)),
    "mla": dict(arch=MLA, cfg=_KV),
    # 6 heads: split at mp 2, context-parallel prefill at mp 4
    "mla6": dict(arch=MLA, cfg=dict(_KV, n_heads=6)),
    "mqa": dict(arch=MQA, cfg=_KV),
    "moe": dict(arch=MOE, cfg=_KV),
    "tied": dict(arch="gemma-7b", cfg=_KV),
    "visual": dict(arch="internvl2-1b", cfg=_KV),
    "hymba": dict(arch="hymba-1.5b", cfg=_KV),
    "rwkv6": dict(arch="rwkv6-7b", cfg={}),
    "whisper": dict(arch="whisper-tiny", cfg=_KV),
}
# the dense-cache scheduler's lanes
DENSE = {"dense-sched": dict(arch=PHI3, cfg=_KV), "mla-sched": dict(arch=MLA, cfg=_KV),
         "mla6-sched": dict(arch=MLA, cfg=dict(_KV, n_heads=6))}
GEN, MAX_LEN = 8, 32
# a temperature: every rank must emit rank 0's draws, whatever its own seed
SAMPLED = dict(lane="dense", temperature=0.7)
# the dense-cache workload: frontier raises for longer prompts and
# pull-backs before a quantum that would not fit (max_len 24)
SCHED = dict(lens=(5, 9, 3, 7, 4, 6), gens=(6, 12, 4, 9, 5, 7), max_len=24, n_slots=3,
             chunk_size=4)
_PERTURBED = ("b", "scale", "bias", "w0", "u", "A_log", "dt_bias", "D", "maa_x",
              "maa_wkvrg", "cm_maa_k", "cm_maa_r")


def spec_of(lane: str) -> dict:
    return ONESHOT.get(lane) or DENSE[lane]


def lane_config(configs, lane: str):
    """The lane's reduced f32 config from either package's ``configs``."""
    spec = spec_of(lane)
    cfg = configs.get_config(spec["arch"]).reduced(compute_dtype="float32")
    return dataclasses.replace(cfg, **spec["cfg"])


def param_key(lane: str) -> str:
    """Lanes that share this key share their weights."""
    spec = spec_of(lane)
    heads = spec["cfg"].get("n_heads")
    return spec["arch"] + (f",h={heads}" if heads else "")


def perturb(tree, seed: int = 7):
    """A copy of a reference parameter tree (nested dicts of numpy
    arrays) with its biases, norm scales and biases, per-head vectors and
    mixing coefficients drawn from ``seed`` around their initial values."""
    rng = np.random.default_rng(seed)

    def walk(t, name):
        if isinstance(t, dict):
            return {k: walk(t[k], k) for k in sorted(t)}
        x = np.asarray(t)
        if name in _PERTURBED and x.dtype.kind == "f":
            scale = 0.5 if name in ("w0", "u", "A_log", "dt_bias") else 0.1
            x = (x + scale * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return walk(tree, "")


def inputs(cfg, lane: str):
    """``(prompts, kw)``: the lane's seeded prompts (ragged on the
    transformer's text lanes, where the reference takes them; a multiple
    of rwkv6's WKV chunk) and whisper's frames or the visual prefix as
    numpy arrays."""
    rng = np.random.default_rng(11)
    kw = {}
    if cfg.family == "transformer" and not cfg.n_visual_tokens:
        prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in (11, 6, 14)]
    else:
        n = 16 if cfg.family == "rwkv6" else 12
        prompts = rng.integers(1, cfg.vocab, (3, n)).tolist()
    if cfg.family == "whisper":
        kw["frames"] = rng.standard_normal((3, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_visual_tokens:
        kw["visual"] = rng.standard_normal((3, cfg.n_visual_tokens, cfg.d_model)).astype(
            np.float32)
    return prompts, kw


def sched_workload(cfg):
    rng = np.random.default_rng(4)
    return [rng.integers(1, cfg.vocab, n).tolist() for n in SCHED["lens"]], list(SCHED["gens"])


def run_dense(sched) -> dict:
    """Serve :data:`SCHED`'s workload on a dense-cache scheduler of either
    package: tokens, admission and finish steps, and the frontier's moves
    ``(from, to)`` (each a ``kvcache.compact``)."""
    moves = []
    move = sched._set_frontier

    def set_frontier(target):
        if int(target) != sched._frontier:
            moves.append((int(sched._frontier), int(target)))
        return move(target)

    sched._set_frontier = set_frontier
    prompts, gens = sched_workload(sched.engine.cfg)
    rids = [sched.submit(p, g) for p, g in zip(prompts, gens)]
    done = sched.run(max_rounds=200)
    return {"tokens": [done[r].tokens.tolist() for r in rids],
            "admitted": [done[r].admitted_step for r in rids],
            "finished": [done[r].finished_step for r in rids], "moves": moves}


def _torch_inputs(kw):
    import torch
    return {k: torch.as_tensor(v) for k, v in kw.items()}


def _oneshot(Engine, cfg, params, lane, mesh, **engine_kw) -> dict:
    from repro_torch.compress.kvcache import _leaf_bytes, cache_report

    import tp_lanes

    prompts, kw = inputs(cfg, lane)
    eng = Engine(cfg, params, max_len=MAX_LEN, device="cpu", mesh=mesh, **engine_kw)
    with tp_lanes.cp_calls() as calls:
        res = eng.generate(prompts, GEN, **_torch_inputs(kw))
        step = eng.generate_stepwise(prompts, GEN, **_torch_inputs(kw))
    return {"tokens": res.tokens.tolist(), "stepwise": step.tokens.tolist(),
            "cp": bool(eng.tp is not None and eng.tp.cp), "cp_calls": calls,
            "logits": res.prefill_logits,
            "report": cache_report(res.cache, None, eng.cache_shards()),
            "shards": eng.cache_shards(),
            "leaf_bytes": {k: _leaf_bytes(k, x)[0] for k, x in res.cache.items()},
            "local": (eng.cfg.n_heads, eng.cfg.n_kv_heads, eng.cfg.d_ff,
                      getattr(eng.cfg, "ssm_heads", 0))}


def _norms(mesh) -> dict:
    """The split norms against the whole ones on seeded inputs: the
    largest difference of the rank's features of the output and of the
    input's gradient (a loss summed over every rank's features)."""
    import torch

    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.runtime import sharding

    cfg = configs.get_config("hymba-1.5b").reduced(compute_dtype="float32")
    tp = sharding.tensor_parallel(cfg, mesh)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((3, 5, 64), generator=gen)
    g = torch.randn((3, 5, 64), generator=gen)
    p = {"scale": 1 + 0.1 * torch.randn((64,), generator=gen),
         "bias": 0.1 * torch.randn((64,), generator=gen)}
    n = 64 // tp.size
    cut = slice(tp.rank * n, (tp.rank + 1) * n)
    out = {}
    for name, fn in (("layer_norm", lambda t, plan: L.layer_norm(p, t, 1e-5, plan)),
                     ("rms_norm", lambda t, plan: L.rms_norm(p, t, cfg, plan))):
        whole = x.clone().requires_grad_(True)
        y = fn(whole, None)
        (y * g).sum().backward()
        part = x[..., cut].clone().requires_grad_(True)
        y_local = fn(part, tp)
        (y_local * g[..., cut]).sum().backward()
        out[name] = (float((y_local - y[..., cut]).abs().max()),
                     float((part.grad - whole.grad[..., cut]).abs().max()))
    return out


# rwkv6 in bf16, deeper than the reduced config: the drift of the sharded
# logits from one device's grows with depth
DRIFT = dict(arch="rwkv6-7b", n_layers=8, batch=4, prompt=64)


def drift_config(configs):
    cfg = configs.get_config(DRIFT["arch"]).reduced(compute_dtype="bfloat16")
    return dataclasses.replace(cfg, n_layers=DRIFT["n_layers"])


def drift_prompts(cfg):
    return np.random.default_rng(1).integers(1, cfg.vocab, (DRIFT["batch"], DRIFT["prompt"]))


def _bf16_drift(mesh):
    """The prefill logits of :data:`DRIFT`'s model on this rank (weights
    drawn by the port's ``init_params``)."""
    from repro_torch import configs
    from repro_torch.models.registry import get_family
    from repro_torch.runtime.engine import Engine

    cfg = drift_config(configs)
    params = get_family(cfg).init_params(cfg, seed=0, device="cpu")
    eng = Engine(cfg, params, max_len=DRIFT["prompt"], device="cpu", mesh=mesh)
    return eng.prefill(drift_prompts(cfg))[1].numpy()


def _round_trip(mesh, np_params) -> dict:
    """Every leaf of each family's parameters through its executed
    placement and back over the ranks (``NamedSharding.shard``, then
    ``unshard``, what ``Checkpointer(mesh=)`` gathers): ``{arch: leaves
    not equal bit for bit}``, and hymba's ``in_proj`` spec."""
    import torch

    from repro_torch import configs, tree
    from repro_torch.runtime import sharding
    from repro_torch.weights import params_from_jax

    out = {}
    for lane in ("hymba", "rwkv6", "whisper"):
        cfg = lane_config(configs, lane)
        params = params_from_jax(np_params[param_key(lane)], cfg, device="cpu")
        shardings = sharding.param_shardings(params, mesh, cfg=cfg)
        out[lane] = [path for (path, x), sh in zip(tree.leaves_with_paths(params),
                                                    tree.leaves(shardings))
                     if not torch.equal(sharding.unshard(sh.shard(x), sh), x)]
        if lane == "hymba":
            out["in_proj"] = repr(shardings["layers"][0]["in_proj"]["w"].spec)
    return out


def rank_run(jobs: dict, np_params: dict, mp: int) -> dict:
    """One gloo rank of a ``(1, mp)`` mesh: ``jobs["oneshot"]`` lanes
    through the one-shot engine, ``jobs["dense"]`` lanes through the
    dense-cache scheduler, and where asked the sampled lane, the split
    norms and the parameters' round trip; the weights are the
    reference's (``np_params[param_key(lane)]``)."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.scheduler import Scheduler
    from repro_torch.weights import params_from_jax

    mesh = make_host_mesh(mp)
    out = {}

    def params_of(lane, cfg):
        return params_from_jax(np_params[param_key(lane)], cfg, device="cpu")

    for lane in jobs.get("oneshot", ()):
        cfg = lane_config(configs, lane)
        out[lane] = _oneshot(Engine, cfg, params_of(lane, cfg), lane, mesh)
    for lane in jobs.get("dense", ()):
        import tp_lanes

        cfg = lane_config(configs, lane)
        sched = Scheduler(Engine(cfg, params_of(lane, cfg), max_len=SCHED["max_len"],
                                 device="cpu", mesh=mesh),
                          n_slots=SCHED["n_slots"], chunk_size=SCHED["chunk_size"])
        with tp_lanes.cp_calls() as calls:
            res = run_dense(sched)
        out[lane] = dict(res, lens=sched.cache["lens"].tolist(), cp_calls=calls,
                         cp=bool(sched.engine.tp.cp),
                         local_kv=tuple(sched.cache[k].shape[3] for k in ("k", "v")
                                        if k in sched.cache))
    if jobs.get("sampled"):
        lane = SAMPLED["lane"]
        cfg = lane_config(configs, lane)
        out["sampled"] = _oneshot(Engine, cfg, params_of(lane, cfg), lane, mesh,
                                  temperature=SAMPLED["temperature"],
                                  seed=1 + dist.get_rank())["tokens"]
    if jobs.get("norms"):
        out["norms"] = _norms(mesh)
    if jobs.get("round_trip"):
        out["round_trip"] = _round_trip(mesh, np_params)
    if jobs.get("bf16_drift"):
        out["bf16_drift"] = _bf16_drift(mesh)
    return out
