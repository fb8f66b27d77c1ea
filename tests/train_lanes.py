"""Lanes of the training-across-ranks tests (a helper module, not a test
file): each lane's architecture, mesh and batch, and the rank functions
that ``launch/mesh.spawn`` runs.  The ranks import torch and
``repro_torch`` only; the tests run the reference on the JAX side and
hand the ranks its parameters as nested dicts of numpy arrays.

Lanes (:func:`rank_lanes`): the reference's sharded-step gate
(granite-moe-3b-a800m at data 4 x model 2, ``tests/test_distributed.py``),
the dense GQA, MLA, MQA and tied-embedding lanes at data 2 x model 2,
hymba-1.5b, rwkv6-7b and whisper-tiny data parallel at data 2 x model 1
and tensor parallel at data 2 x model 2 (every group split), and
hymba-1.5b at data 1 x model 4 (its 2 KV heads leave only the MLP and
the vocabulary split); and the sequence layout (the config's
``seq_shard_activations`` kept on): Megatron-SP on the four transformer
lanes at data 2 x model 2 and on the MoE gate's, context-parallel
attention at data 1 x model 4 on phi3 (its 2 KV heads do not divide 4),
on phi3 with an 8-token window, on internvl2-1b with its visual prefix
and a 250-row vocabulary (the head whole: the loss on a rank's
positions) and on hymba-1.5b; rank 0 returns the whole parameters after one
step and the whole gradients of that step (gathered over the mesh,
``sharding.unshard``) in the reference's layout, and every rank the
leaves whose gradients it all-reduced over ``"model"`` and those
all-reduces (the ``wire`` counter).  :func:`rank_pods`
runs the compressed gate (internvl2-1b at pod 2 x data 2 x model 2),
:func:`rank_elastic` the elastic re-mesh's moves.
"""
from __future__ import annotations

import dataclasses

import numpy as np

BATCH, SEQ, SEED = 8, 32, 5
LR = 1e-3

LANES = {
    "moe": dict(arch="granite-moe-3b-a800m", mesh=(4, 2)),
    "gqa": dict(arch="phi3-medium-14b", mesh=(2, 2)),
    "mla": dict(arch="minicpm3-4b", mesh=(2, 2)),
    "mqa": dict(arch="granite-34b", mesh=(2, 2)),
    "tied": dict(arch="gemma-7b", mesh=(2, 2)),
    "hymba": dict(arch="hymba-1.5b", mesh=(2, 1)),
    "rwkv6": dict(arch="rwkv6-7b", mesh=(2, 1)),
    "whisper": dict(arch="whisper-tiny", mesh=(2, 1)),
    "hymba-tp": dict(arch="hymba-1.5b", mesh=(2, 2)),
    "rwkv6-tp": dict(arch="rwkv6-7b", mesh=(2, 2)),
    "whisper-tp": dict(arch="whisper-tiny", mesh=(2, 2)),
    "hymba-mlp": dict(arch="hymba-1.5b", mesh=(1, 4)),
    # the sequence layout
    "gqa-sp": dict(arch="phi3-medium-14b", mesh=(2, 2), seq=True),
    "mla-sp": dict(arch="minicpm3-4b", mesh=(2, 2), seq=True),
    "mqa-sp": dict(arch="granite-34b", mesh=(2, 2), seq=True),
    "tied-sp": dict(arch="gemma-7b", mesh=(2, 2), seq=True),
    "moe-sp": dict(arch="granite-moe-3b-a800m", mesh=(4, 2), seq=True),
    "gqa-cp": dict(arch="phi3-medium-14b", mesh=(1, 4), seq=True),
    "window-cp": dict(arch="phi3-medium-14b", mesh=(1, 4), seq=True,
                      over=dict(sliding_window=8)),
    "visual-cp": dict(arch="internvl2-1b", mesh=(1, 4), seq=True, over=dict(vocab=250)),
    "hymba-cp": dict(arch="hymba-1.5b", mesh=(1, 4), seq=True),
    # FSDP (the configs' fsdp kept on): data 2, and data 2 x model 2
    "gqa-fsdp": dict(arch="phi3-medium-14b", mesh=(2, 1), fsdp=True),
    "mla-fsdp": dict(arch="minicpm3-4b", mesh=(2, 1), fsdp=True),
    "moe-fsdp": dict(arch="granite-moe-3b-a800m", mesh=(2, 1), fsdp=True),
    "rwkv6-fsdp": dict(arch="rwkv6-7b", mesh=(2, 1), fsdp=True),
    "gqa-fsdp-tp": dict(arch="phi3-medium-14b", mesh=(2, 2), fsdp=True),
    "mla-fsdp-tp": dict(arch="minicpm3-4b", mesh=(2, 2), fsdp=True),
    "moe-fsdp-tp": dict(arch="granite-moe-3b-a800m", mesh=(2, 2), fsdp=True),
    "rwkv6-fsdp-tp": dict(arch="rwkv6-7b", mesh=(2, 2), fsdp=True),
    "tied-sp-fsdp": dict(arch="gemma-7b", mesh=(2, 2), seq=True, fsdp=True),
}

# lanes whose gradients the ranks also take in bf16 (their drift from one
# device's bf16 gradients against bf16's own rounding)
DRIFT_LANES = ("hymba-tp", "rwkv6-tp")

# the reference's compressed-wire gate
POD_ARCH, POD_SEED, POD_MESH = "internvl2-1b", 9, (2, 2, 2)


def lane_config(configs, arch: str, seq: bool = False, fsdp: bool = False, **over):
    """The reduced f32 config of either package, as the gates build it
    (``over``: fields changed on the reduced config; ``seq`` and
    ``fsdp``: the sequence layout's and FSDP's flags kept)."""
    cfg = configs.get_config(arch).reduced(compute_dtype="float32", **over)
    return dataclasses.replace(cfg, fsdp=fsdp, seq_shard_activations=seq)


def config_of(configs, lane: str):
    """A lane's config in either package."""
    spec = LANES[lane]
    return lane_config(configs, spec["arch"], spec.get("seq", False), spec.get("fsdp", False),
                       **spec.get("over", {}))


def ref_key(lane: str) -> str:
    """The key of a lane's weights and reference run: its architecture
    and changed fields (the flag changes neither: the reference's
    single-device step is the same with it on,
    ``tests/test_torch_train_seq.py``)."""
    spec = LANES[lane]
    return spec["arch"] + "".join(f"/{k}={v}" for k, v in sorted(spec.get("over", {}).items()))


def pod_config(configs):
    """The compressed gate's config: internvl2-1b reduced, f32, no visual
    tokens, posit16 on the wire."""
    cfg = lane_config(configs, POD_ARCH)
    return dataclasses.replace(cfg, batch_axes=("pod", "data"), grad_compress="posit16",
                               n_visual_tokens=0)


def _whole(tree, mesh, cfg):
    """A rank's tree gathered whole over the mesh, in the reference's
    layout (numpy)."""
    from repro_torch import tree as TT
    from repro_torch.runtime import sharding
    from repro_torch.weights import params_to_jax

    shards = TT.leaves(sharding.param_shardings(tree, mesh, cfg=cfg, fsdp=cfg.fsdp))
    whole = [sharding.unshard(x, sh) for x, sh in zip(TT.leaves(tree), shards)]
    return params_to_jax(TT.unflatten(tree, whole))


def _rank_params(ref_params, cfg, mesh):
    from repro_torch.runtime import sharding
    from repro_torch.weights import params_from_jax

    return sharding.shard_params(params_from_jax(ref_params, cfg, device="cpu"), mesh, cfg,
                                 fsdp=cfg.fsdp)


def rank_lanes(lanes, ref_params) -> dict:
    """One gloo rank: each lane of ``lanes`` (all of one world size) on a
    ``("data", "model")`` mesh: the gradients of the reference gate's
    batch, then one step.  Rank 0 returns ``{lane: {"loss", "grad_norm",
    "grad_loss", "params", "grads", "partial", "grad_wire"}}``; the others
    ``{lane: {"partial", "grad_wire"}}``: the paths of the leaves whose
    gradients the rank all-reduces over ``"model"``
    (``sharding.partial_grad_leaves``), the ``"model"`` all-reduces of
    gradients that the gradients' call made (calls, bytes) and that
    call's whole ``wire`` (``"axis/op/what/dtype"`` keys)."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch import tree as TT
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import collectives, sharding, train_loop

    out = {}
    for lane in lanes:
        spec = LANES[lane]
        cfg = config_of(configs, lane)
        mesh = make_mesh(spec["mesh"], ("data", "model"))
        params = _rank_params(ref_params[ref_key(lane)], cfg, mesh)
        batch = Pipeline(DataConfig(seed=SEED), cfg, BATCH, SEQ, device="cpu").batch_at(0)
        tp = sharding.tensor_parallel(cfg, mesh, seq=cfg.seq_shard_activations)
        partial = [p for (p, _), part in zip(TT.leaves_with_paths(params),
                                             sharding.partial_grad_leaves(params, cfg, tp))
                   if part]
        collectives.wire.clear()
        g_loss, grads = train_loop.make_grad_fn(cfg, mesh)(params, batch)
        wire = {"/".join(k): list(v) for k, v in collectives.wire.items()}
        grad_wire = wire.get("model/all_reduce/grad/float32", [0, 0])
        grads = _whole(TT.tree_map(torch.clone, grads), mesh, cfg)
        bf16 = None
        if lane in DRIFT_LANES:
            bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
            _, g16 = train_loop.make_grad_fn(bcfg, mesh)(params, batch)
            bf16 = _whole(TT.tree_map(torch.clone, g16), mesh, bcfg)
        opt_cfg = adamw.AdamWConfig(lr=LR)
        opt = adamw.init(params, opt_cfg)
        step = train_loop.make_train_step(cfg, opt_cfg, mesh=mesh)
        params, opt, m = step(params, opt, batch, 0)
        whole = _whole(params, mesh, cfg)
        out[lane] = dict(partial=partial, grad_wire=grad_wire, wire=wire)
        if cfg.fsdp:
            out[lane]["fsdp"] = _fsdp_layout(params, opt, mesh, cfg, ref_params[ref_key(lane)])
            twin = _data_parallel_step(ref_params[ref_key(lane)], cfg, mesh, batch, opt_cfg)
        if dist.get_rank() == 0:
            out[lane].update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                             grad_loss=float(g_loss), params=whole, grads=grads,
                             bf16_grads=bf16)
            if cfg.fsdp:
                out[lane]["twin"] = twin
    return out


def _data_parallel_step(np_params, cfg, mesh, batch, opt_cfg) -> dict:
    """An FSDP lane's twin: the same step on the same mesh with ``fsdp``
    off (data parallelism alone); its loss, norm and whole parameters."""
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop

    dcfg = dataclasses.replace(cfg, fsdp=False)
    params = _rank_params(np_params, dcfg, mesh)
    step = train_loop.make_train_step(dcfg, opt_cfg, mesh=mesh)
    params, _, m = step(params, adamw.init(params, opt_cfg), batch, 0)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                params=_whole(params, mesh, dcfg))


def _fsdp_layout(params, opt, mesh, cfg, np_params) -> dict:
    """A rank's FSDP pieces: ``{"leaves": [(path, split dim or None,
    piece bytes, the bytes of the leaf as "model" alone places it)],
    "m", "v": bytes of the optimizer's pieces}``."""
    from repro_torch import tree as TT
    from repro_torch.runtime import sharding
    from repro_torch.weights import params_from_jax

    local = sharding.shard_params(params_from_jax(np_params, cfg, device="cpu"), mesh, cfg)
    dims = sharding.fsdp_dims(params, mesh, cfg)

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in TT.leaves(tree))
    return {"leaves": [(path, d, x.numel() * x.element_size(), y.numel() * y.element_size())
                       for (path, x), y, d in zip(TT.leaves_with_paths(params),
                                                  TT.leaves(local), dims)],
            "m": nbytes(opt["m"]), "v": nbytes(opt["v"])}


def one_device_grads(np_params, arch: str, dtype: str):
    """The port's single-device gradients of the gate's batch at compute
    ``dtype`` (f32 master weights ``np_params``), in the reference's
    layout (numpy)."""
    import torch

    from repro_torch import configs
    from repro_torch import tree as TT
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.runtime import train_loop
    from repro_torch.weights import params_from_jax, params_to_jax

    cfg = dataclasses.replace(lane_config(configs, arch), compute_dtype=dtype)
    params = params_from_jax(np_params, cfg, device="cpu")      # f32 masters
    batch = Pipeline(DataConfig(seed=SEED), cfg, BATCH, SEQ, device="cpu").batch_at(0)
    _, grads = train_loop.make_grad_fn(cfg)(params, batch)
    return params_to_jax(TT.tree_map(torch.clone, grads))


def _pod_step(ref_params, cfg, mesh, batch):
    """One pod-compressed step of ``cfg`` on ``mesh`` from the reference's
    weights: ``(params, opt, ef, metrics, wire, sent)``, ``sent`` the
    patterns this rank put on the pod wire, leaf by leaf (the gathered
    ``(n_pods, ...)`` tensors)."""
    import torch

    from repro_torch.compress import gradient as gc
    from repro_torch.optim import adamw
    from repro_torch.runtime import collectives, train_loop

    params = _rank_params(ref_params, cfg, mesh)
    opt_cfg = adamw.AdamWConfig(lr=LR)
    opt = adamw.init(params, opt_cfg)
    ef = gc.init_error_state(params)
    n_pods = POD_MESH[0]
    tiled = {k: v.reshape((n_pods, BATCH // n_pods) + tuple(v.shape[1:]))
             for k, v in batch.items()}
    step = train_loop.make_train_step(cfg, opt_cfg, n_pods=n_pods, compressed=True,
                                      mesh=mesh)
    sent, gather = [], collectives.gather_axis

    def recording(t, mesh, axis, what="grad"):
        out = gather(t, mesh, axis, what)
        if axis == "pod":
            sent.append(out.clone())
        return out
    collectives.wire.clear()
    train_loop.C.gather_axis = recording
    try:
        params, opt, ef, m = step(params, opt, ef, tiled, 0)
    finally:
        train_loop.C.gather_axis = gather
    wire = {"/".join(k): v for k, v in collectives.wire.items()}
    return params, opt, ef, m, wire, [torch.clone(x) for x in sent]


def rank_pods(ref_params, ckdir=None) -> dict:
    """One gloo rank of the compressed gate: internvl2-1b at pod 2 x
    data 2 x model 2, one pod-compressed step on the pod-tiled batch
    (seed 9).  Returns the loss, whether this rank's error feedback is
    non-zero and the collectives on the wire; rank 0 the whole
    parameters after the step too.  Then the same step under FSDP
    (``cfg.fsdp``, the same ranks): under ``"fsdp"`` its loss, norm,
    wire, whole parameters (rank 0), whether its pod patterns, error
    feedback and updated pieces are the step's without FSDP sliced to
    this rank's pieces bit for bit (``sliced_equal``, with the paths
    that differ), and, with ``ckdir``, whether its pieces saved under
    the mesh and restored whole on one device give them back bit for
    bit (``restored_equal``).  Under ``"serve"``, the serving steps on
    the same mesh against one device (:func:`_serve_steps`)."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch import tree as TT
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding
    from repro_torch.weights import params_from_jax

    cfg = pod_config(configs)
    mesh = make_mesh(POD_MESH, ("pod", "data", "model"))
    batch = Pipeline(DataConfig(seed=POD_SEED), cfg, BATCH, SEQ, device="cpu").batch_at(0)
    params, opt, ef, m, wire, sent = _pod_step(ref_params, cfg, mesh, batch)
    n_elems = sum(p.numel() for p in TT.leaves(params))
    whole = _whole(params, mesh, cfg)           # every rank of "model" takes part
    out = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), wire=wire,
               n_elems=n_elems, ef_nonzero=any(bool(torch.any(e != 0)) for e in TT.leaves(ef)),
               params=None if dist.get_rank() else whole)

    fcfg = dataclasses.replace(cfg, fsdp=True)
    fp, fopt, fef, fm, fwire, fsent = _pod_step(ref_params, fcfg, mesh, batch)
    dims = sharding.fsdp_dims(fp, mesh, fcfg)
    rank, n = mesh.get_local_rank("data"), sharding.axis_sizes(mesh)["data"]

    def sliced(x, d, lead=0):
        if d is None:
            return x
        k = x.shape[d + lead] // n
        return x.narrow(d + lead, rank * k, k)
    differ = []
    for (path, p), d, w, q, fq, e, fe in zip(TT.leaves_with_paths(fp), dims, TT.leaves(params),
                                             sent, fsent, TT.leaves(ef), TT.leaves(fef)):
        for what, a, b in (("param", p, sliced(w, d)), ("patterns", fq, sliced(q, d, 1)),
                           ("ef", fe, sliced(e, d))):
            if a.shape != b.shape or not np.array_equal(bits(a), bits(b)):
                differ.append(f"{what}:{path}")
    fout = dict(loss=float(fm["loss"]), grad_norm=float(fm["grad_norm"]), wire=fwire,
                n_elems=sum(p.numel() for p in TT.leaves(fp)),
                n_split=sum(d is not None for d in dims), n_leaves=len(dims),
                sliced_equal=not differ, differ=differ[:20],
                params=_whole(fp, mesh, fcfg))
    if ckdir is not None:
        state = {"params": fp, "opt": fopt}
        sh = state_shardings(state, mesh, fcfg)
        Checkpointer(ckdir, keep=1, mesh=mesh).save(1, state, shardings=sh)
        whole_p = params_from_jax(ref_params, fcfg, device="cpu")
        template = {"params": whole_p, "opt": adamw.init(whole_p, adamw.AdamWConfig(lr=LR))}
        restored, _ = Checkpointer(ckdir, keep=1).restore(1, template, device="cpu")
        fout["restored_equal"] = all(
            np.array_equal(bits(s.shard(r)), bits(x)) for r, s, x in
            zip(TT.leaves(restored), TT.leaves(sh), TT.leaves(state)))
    if dist.get_rank():
        fout["params"] = None
    out["fsdp"] = fout
    out["serve"] = _serve_steps(ref_params, cfg, mesh, batch)
    return out


def _serve_steps(ref_params, cfg, mesh, batch) -> dict:
    """``make_prefill_step`` and ``make_serve_step`` on this rank's shard
    of ``mesh`` against one device's: the largest logit differences of
    a 16-token prefill and of one greedy decode step."""
    from repro_torch.runtime import sharding, train_loop
    from repro_torch.weights import params_from_jax

    whole = params_from_jax(ref_params, cfg, device="cpu")
    local = sharding.shard_params(whole, mesh, cfg)
    toks = {"tokens": batch["tokens"][:, :16]}
    cache1, logits1 = train_loop.make_prefill_step(cfg)(whole, toks, max_len=24)
    cache_m, logits_m = train_loop.make_prefill_step(cfg, mesh)(local, toks, max_len=24)
    tok = logits1.argmax(-1)
    step1, _ = train_loop.make_serve_step(cfg)(whole, cache1, tok)
    step_m, _ = train_loop.make_serve_step(cfg, mesh)(local, cache_m, tok)
    return dict(prefill=float((logits1 - logits_m).abs().max()),
                decode=float((step1 - step_m).abs().max()),
                kv_split=tuple(cache_m["k"].shape) != tuple(cache1["k"].shape))


# ---------------------------------------------------------------------------
# The elastic re-mesh (examples/elastic_restart.py's model and data)
# ---------------------------------------------------------------------------

ELASTIC_ARCH, ELASTIC_SEED, ELASTIC_BATCH, ELASTIC_SEQ = "gemma-7b", 17, 8, 64
ELASTIC_STEPS = 2          # steps before the save; the next one continues
# hymba's save under "model" 2: its in_proj is a Segments leaf there
SEGMENTS_ARCH, SEGMENTS_MESH = "hymba-1.5b", (1, 2)


def elastic_setup(configs, arch=ELASTIC_ARCH):
    """``(cfg, opt_cfg, pipeline)`` of the elastic lanes (posit16 moments,
    so the optimizer state holds patterns as well as f32 leaves)."""
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.optim import adamw

    cfg = lane_config(configs, arch)
    return cfg, adamw.AdamWConfig(lr=1e-3, posit_moments=True), Pipeline(
        DataConfig(seed=ELASTIC_SEED), cfg, ELASTIC_BATCH, ELASTIC_SEQ, device="cpu")


def state_shardings(state, mesh, cfg):
    """The placements of a ``{"params", "opt"}`` state on ``mesh`` (its
    FSDP pieces too where ``cfg.fsdp``)."""
    from repro_torch.runtime import sharding
    return {key: sharding.param_shardings(state[key], mesh, cfg=cfg, fsdp=cfg.fsdp)
            for key in ("params", "opt")}


def bits(t):
    """A tensor's bits as numpy (patterns and floats alike)."""
    import torch

    from repro_torch.core.types import signed_view
    t = t.detach().cpu()
    return (signed_view(t) if t.dtype == torch.uint16 else t.view(torch.int32)).numpy().copy()


def rank_elastic(np_params, dirs) -> dict:
    """Two gloo ranks.  Train ``ELASTIC_STEPS`` steps at ``(data 2, model
    1)`` and save to ``dirs["dp"]``, the same at ``(data 1, model 2)``
    to ``dirs["tp"]`` and under FSDP at ``(data 2, model 1)`` to
    ``dirs["fsdp"]``; then restore ``dirs["one"]`` (a single device's
    checkpoint) at ``(data 1, model 2)`` and run the next step; then
    train hymba ``ELASTIC_STEPS`` steps at ``SEGMENTS_MESH`` and save to
    ``dirs["segments"]``.  ``np_params``: the reference's weights by
    architecture.  Each rank returns, for ``"dp"``, ``"tp"``, ``"fsdp"``
    and ``"segments"``, its losses and its state's leaves (bits) with their
    specs at the save, and for ``"one"`` the restored leaves (bits),
    their specs and the next step's loss."""
    from repro_torch import configs
    from repro_torch import tree as TT
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop

    cfg, opt_cfg, pipe = elastic_setup(configs)
    ref_params = np_params[ELASTIC_ARCH]
    out = {}
    for name, shape in (("dp", (2, 1)), ("tp", (1, 2)), ("fsdp", (2, 1))):
        mesh = make_mesh(shape, ("data", "model"))
        cfg = dataclasses.replace(cfg, fsdp=name == "fsdp")
        params = _rank_params(ref_params, cfg, mesh)
        opt = adamw.init(params, opt_cfg)
        step = train_loop.make_train_step(cfg, opt_cfg, mesh=mesh)
        losses = []
        for i in range(ELASTIC_STEPS):
            params, opt, m = step(params, opt, pipe.batch_at(i), i)
            losses.append(float(m["loss"]))
        state = {"params": params, "opt": opt}
        sh = state_shardings(state, mesh, cfg)
        Checkpointer(dirs[name], keep=1, mesh=mesh).save(ELASTIC_STEPS, state, shardings=sh)
        out[name] = dict(losses=losses, leaves=[bits(x) for x in TT.leaves(state)],
                         specs=[s.spec for s in TT.leaves(sh)])

    cfg = dataclasses.replace(cfg, fsdp=False)
    mesh = make_mesh((1, 2), ("data", "model"))
    params = _rank_params(ref_params, cfg, mesh)
    template = {"params": params, "opt": adamw.init(params, opt_cfg)}
    sh = state_shardings(template, mesh, cfg)
    state, step0 = Checkpointer(dirs["one"], keep=1).restore(ELASTIC_STEPS, template,
                                                             shardings=sh)
    leaves = [bits(x) for x in TT.leaves(state)]
    step = train_loop.make_train_step(cfg, opt_cfg, mesh=mesh)
    _, _, m = step(state["params"], state["opt"], pipe.batch_at(step0), step0)
    out["one"] = dict(leaves=leaves, specs=[s.spec for s in TT.leaves(sh)],
                      step=step0, loss=float(m["loss"]))

    cfg, opt_cfg, pipe = elastic_setup(configs, SEGMENTS_ARCH)
    mesh = make_mesh(SEGMENTS_MESH, ("data", "model"))
    params = _rank_params(np_params[SEGMENTS_ARCH], cfg, mesh)
    opt = adamw.init(params, opt_cfg)
    step = train_loop.make_train_step(cfg, opt_cfg, mesh=mesh)
    losses = []
    for i in range(ELASTIC_STEPS):
        params, opt, m = step(params, opt, pipe.batch_at(i), i)
        losses.append(float(m["loss"]))
    state = {"params": params, "opt": opt}
    sh = state_shardings(state, mesh, cfg)
    Checkpointer(dirs["segments"], keep=1, mesh=mesh).save(ELASTIC_STEPS, state, shardings=sh)
    out["segments"] = dict(losses=losses, leaves=[bits(x) for x in TT.leaves(state)],
                           specs=[s.spec for s in TT.leaves(sh)])
    return out
