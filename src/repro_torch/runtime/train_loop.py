"""Train, serve and prefill step factories, on one device or a rank mesh.

The port of ``repro/runtime/train_loop.py``.  The gradient is autograd
over the families' ``train_loss`` (the reference differentiates its XLA
ops the same way: the JAX package has no backward kernel).  With
``cfg.grad_accum`` > 1 the batch is cut into that many microbatches in
order; their gradients accumulate in the parameters' ``.grad`` (f32 for
f32 parameters), first plus second plus ..., as the reference's scan
adds them, and are then scaled by ``1/accum``; the loss is the mean.
The step then runs :func:`optim.adamw.update` on the cosine schedule's
learning rate.

Under a rank mesh (``mesh=``, ``launch/mesh.make_mesh``; one process a
rank), where the reference lets GSPMD place a jitted step:

* **the standard step**: every rank holds the global batch (the
  pipeline draws it from its seed) and runs the rows that
  ``("pod", "data")`` give it (``sharding.batch_rows``), through a
  tensor-parallel plan where ``"model"`` > 1 (``sharding.
  tensor_parallel``, every family).  Microbatches are the
  reference's global ones, rows ``[i B/accum, (i+1) B/accum)``; a rank
  runs its part of each, and each part's loss sum divides by its
  microbatch's global label count, so that the sum over the ranks is
  the reference's mean.  The gradients are then summed in f32 over
  ``"data"`` (and ``"pod"``), those of the leaves each rank holds whole
  but uses a slice of over ``"model"`` (``sharding.partial_grad_leaves``:
  the MoE router, rwkv6's per-head leaves, hymba's, and the whole ``B``
  and ``C`` columns of its ``in_proj``), and AdamW runs on every rank
  with the single device's clip scale.  Where ``cfg.seq_shard_activations``
  is set and ``"model"`` divides a call's sequence, the plan takes the
  sequence layout (``sharding.tensor_parallel(seq=True)``: the
  transformer's Megatron-SP residual and context-parallel attention,
  hymba's context-parallel attention), whose partial leaves are
  all-reduced the same way; elsewhere the head layout runs.
* **FSDP** (``cfg.fsdp`` with ``"data"`` > 1; ``sharding.shard_params(
  fsdp=True)`` gives each rank its pieces, and ``adamw.init`` on them
  the optimizer's): a leaf that ``"data"`` splits is gathered whole
  before its use (``collectives.DataShards``: the top-level leaves a
  microbatch, a layer's inside the layer through ``layers.layer_gather``,
  so again in its recompute) and its gradient is reduce-scattered in the
  backward pass in place of the ``"data"`` all-reduce; every rank of
  the row axes must take part in as many microbatches.  The update runs
  on the pieces, the gradient norm summing them over ``"data"``.
* **the pod-compressed step** (``compressed=True``, ``n_pods`` > 1,
  ``cfg.grad_compress``, a ``"pod"`` axis of ``n_pods``): the
  reference's ``train_step(params, opt_state, ef_state, batch, step)``
  on a pod-tiled batch ``(n_pods, B / n_pods, ...)``.  Each pod's
  gradient comes from the standard machinery inside the pod (its rows
  over ``"data"``, ``"model"`` as above, no microbatches, as the
  reference's ``vmap`` of ``value_and_grad``), then error feedback
  quantizes it (rows 1 and 2), the posit patterns alone cross
  ``"pod"`` at their own two bytes an element (``collectives.
  gather_axis``), row 2 decodes the gathered ``(n_pods, ...)`` leaf in
  one launch, and the f32 mean over pods feeds AdamW.  ``ef_state`` is
  this pod's residual, shaped like the rank's parameters
  (``sharding.ef_shardings``).  Under ``cfg.fsdp`` (the reference's dry
  run reaches this in its multi-pod train cells) the gradient arrives
  as the rank's FSDP pieces, reduce-scattered over ``"data"`` within the
  pod (``DataShards``); the residual, the patterns on the pod wire and
  the update are then the pieces', each the slice of what the step
  without FSDP computes, so the pod wire a rank carries falls to
  1/``"data"`` of that step's.

Serving: :func:`make_prefill_step` and :func:`make_serve_step` under a
mesh run a rank's shard through ``sharding.tensor_parallel(serve=True)``
as ``Engine(mesh=)`` does (context-parallel prefill where the plan takes
it), on the rank-local config.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch import tree as T
from repro_torch.compress import gradient as gc
from repro_torch.models import get_family
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.runtime import collectives as C
from repro_torch.runtime import sharding


def make_grad_fn(cfg: ModelConfig, mesh=None, *, axes=("pod", "data"), accum=None):
    """``grads_of(params, batch) -> (loss, grads)``: the mean loss (a 0-d
    f32 tensor) and a tree of f32 gradients shaped like ``params`` (the
    parameters' ``.grad`` tensors, which the next call replaces), over
    ``accum`` microbatches (default ``cfg.grad_accum``).

    On a rank of ``mesh``: ``params`` is this rank's shard and ``batch``
    the whole batch that ``axes`` split (every rank passes the same one);
    the rank runs its rows of each microbatch, each part's loss sum
    divided by its microbatch's label count, and the loss and gradients
    are summed over the axes that split the rows (``sharding.
    batch_axes``: none where they do not divide the batch, which every
    rank then runs whole; the partial leaves' over ``"model"`` too), so
    that every rank holds one device's, its own slices of the split
    leaves."""
    fam = get_family(cfg)
    accum = max(1, cfg.grad_accum if accum is None else accum)
    seq_tp = None if mesh is None else sharding.tensor_parallel(
        cfg, mesh, seq=cfg.seq_shard_activations)
    lcfg = sharding.local_config(cfg, seq_tp)
    sizes = {} if mesh is None else sharding.axis_sizes(mesh)
    partials = {}           # the partial leaves of each layout, fixed by cfg and mesh
    fsdp = {}               # the FSDP plan by whether the rows split, fixed likewise

    def grads_of(params, batch):
        leaves = T.leaves(params)
        tp = seq_tp
        if tp is not None and tp.seq and batch["tokens"].shape[1] % tp.size:
            tp = dataclasses.replace(tp, seq=False)      # "model" must divide S
        kw = {} if tp is None else {"tp": tp}
        layout = tp is not None and tp.seq
        if layout not in partials:
            partials[layout] = sharding.partial_grad_leaves(params, cfg, tp)
        partial = partials[layout]
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        b = batch["tokens"].shape[0]
        if b % accum:
            raise ValueError(f"batch {b} is not a multiple of grad_accum {accum}")
        mb = b // accum
        # the axes that split the rows (none where they do not divide the
        # batch: every rank then runs it whole, and nothing is summed)
        split = () if mesh is None else sharding.batch_axes(b, mesh, axes) or ()
        r0, r1 = (0, b) if mesh is None else sharding.batch_rows(b, mesh, axes)
        rows_split = "data" in split
        if rows_split not in fsdp:
            fsdp[rows_split] = data_shards(params, cfg, mesh, rows_split)
        shards = fsdp[rows_split]
        if shards is not None:
            _check_even_parts(b, mb, split, sizes)
            by_id = {id(p): d for p, d in zip(leaves, shards.dims) if d is not None}
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(accum):
            lo, hi = max(r0, i * mb), min(r1, (i + 1) * mb)
            if lo >= hi:
                continue
            if mesh is not None:
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                kw["denom"] = L.xent_count(fam.loss_labels(micro, cfg)[1], cfg.loss_chunk)
            rows = {k: v[lo:hi] for k, v in batch.items()}
            if shards is None:
                loss = fam.train_loss(params, rows, lcfg, **kw)
            else:       # the top-level leaves whole now, each layer's inside it
                seen = set()
                gather = functools.partial(shards.whole, by_id=by_id, seen=seen)
                view = {k: v if isinstance(v, list) else gather(v) for k, v in params.items()}
                with L.layer_gather(gather):
                    loss = fam.train_loss(view, rows, lcfg, **kw)
                _check_gathered(params, by_id, seen)
            loss.backward()
            lsum = lsum + loss.detach()
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            p.requires_grad_(False)
        grads = [p.grad for p in leaves]
        if accum > 1:
            for g in grads:
                g.mul_(1.0 / accum)
            lsum = lsum * (1.0 / accum)
        pieces = [False] * len(grads) if shards is None else [d is not None
                                                              for d in shards.dims]
        for a in split:
            if sizes[a] > 1:
                C.all_reduce_axis(lsum, mesh, a, what="loss")
                for g, piece in zip(grads, pieces):
                    if not (piece and a == "data"):     # reduce-scattered in backward
                        C.all_reduce_axis(g, mesh, a)
        for g, part in zip(grads, partial):
            if part is True:
                g.copy_(tp.all_reduce(g, what="grad"))
            elif part:          # (dim, Segments): the split segments are this rank's own
                for piece, split in part[1].pieces(g, part[0], tp.size):
                    if not split:
                        piece.copy_(tp.all_reduce(piece, what="grad"))
        return lsum, T.tree_map(lambda p: p.grad, params)

    return grads_of


def data_shards(params, cfg: ModelConfig, mesh, rows_split: bool = True):
    """The FSDP plan (``collectives.DataShards``) of a rank's ``params``
    where ``cfg.fsdp`` is set and the mesh's ``"data"`` axis is > 1
    (``sharding.fsdp_dims``: each leaf's split dim), else ``None``."""
    if mesh is None or not cfg.fsdp or sharding.axis_sizes(mesh).get("data", 1) == 1:
        return None
    group, rank, size = C.axis_group(mesh, "data")
    return C.DataShards(group, rank, size, tuple(sharding.fsdp_dims(params, mesh, cfg)),
                        rows_split)


def _check_gathered(params, by_id: dict, seen: set):
    """Every FSDP piece must have gone through the layer gather: a layer
    loop that bypasses ``layers.remat_layer`` and ``layers.gathered``
    would run on the pieces themselves."""
    if len(seen) < len(by_id):
        missed = [p for p, x in T.leaves_with_paths(params) if id(x) in by_id.keys() - seen]
        raise RuntimeError(f"FSDP: the forward pass used the pieces of {missed} ungathered "
                           "(a layer loop outside layers.remat_layer / layers.gathered)")


def _check_even_parts(b: int, mb: int, split, sizes: dict):
    """FSDP's gathers run inside every microbatch a rank takes part in,
    so every rank of the row axes must take part in as many."""
    n = 1
    for a in split:
        n *= sizes[a]
    per = b // n
    parts = {len({r // mb for r in range(i * per, (i + 1) * per)}) for i in range(n)}
    if len(parts) > 1:
        raise ValueError(f"FSDP: the ranks' rows of a batch of {b} meet different numbers "
                         f"of microbatches of {mb} rows")


def pod_mean(gathered, wire: str):
    """The f32 mean over pods of gathered ``(n_pods, ...)`` pattern
    leaves (a tree or one leaf): one dequantize a leaf
    (``gradient.decompress``), then the mean over axis 0, as the
    reference's ``decompress(q_rep).mean(0)``."""
    return T.tree_map(lambda t: t.mean(dim=0), gc.decompress(gathered, wire))


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    *, n_pods: int = 1, compressed: bool = False,
                    total_steps: int = 10_000, mesh=None):
    """``train_step(params, opt_state, batch, step) -> (params,
    opt_state, {"loss", "grad_norm"})``; the parameters and ``v`` update
    in place, and each parameter's ``.grad`` is released after the
    update.  With ``mesh``, each rank passes its shard of the parameters
    (``sharding.shard_params``) and of the optimizer state, and the
    global batch.  The pod-compressed step (module docstring) is
    ``train_step(params, opt_state, ef_state, batch, step) -> (params,
    opt_state, ef_state, metrics)``."""
    pod_step = compressed and n_pods > 1 and bool(cfg.grad_compress)
    if pod_step and (mesh is None or sharding.axis_sizes(mesh).get("pod", 1) != n_pods):
        raise NotImplementedError(
            f"the pod-compressed train step needs a pod mesh: a rank mesh whose "
            f"'pod' axis has n_pods={n_pods} ranks (make_mesh)")
    tp = None if mesh is None else sharding.tensor_parallel(cfg, mesh)
    grads_of = make_grad_fn(cfg, mesh, axes=("data",), accum=1) if pod_step \
        else make_grad_fn(cfg, mesh)
    norm = {}               # fixed by cfg and mesh: set on the first step

    def update(params, opt_state, grads, step, dev):
        if not norm:
            norm.update(split=None if tp is None else sharding.split_leaves(params, cfg, mesh),
                        shards=data_shards(params, cfg, mesh))
        lr_scale = adamw.cosine_schedule(torch.tensor(int(step), device=dev),
                                         total=total_steps)
        return adamw.update(grads, opt_state, params, opt_cfg, lr_scale, tp=tp, **norm)

    def release(params):
        for p in T.leaves(params):
            p.grad = None

    if not pod_step:
        def train_step(params, opt_state, batch, step):
            loss, grads = grads_of(params, batch)
            params, opt_state, metrics = update(params, opt_state, grads, step, loss.device)
            del grads
            release(params)
            return params, opt_state, {"loss": loss, **metrics}

        return train_step

    wire = cfg.grad_compress

    def train_step(params, opt_state, ef_state, batch, step):
        pod = mesh.get_local_rank("pod")
        loss, grads = grads_of(params, {k: v[pod] for k, v in batch.items()})
        q, ef_state = gc.compress_with_feedback(grads, ef_state, wire)
        del grads
        release(params)
        # leaf by leaf: the patterns cross "pod", row 2 decodes them
        g_hat = T.tree_map(lambda t: pod_mean(C.gather_axis(t, mesh, "pod"), wire), q)
        del q
        loss = C.all_reduce_axis(loss.clone(), mesh, "pod", what="loss") / n_pods
        params, opt_state, metrics = update(params, opt_state, g_hat, step, loss.device)
        return params, opt_state, ef_state, {"loss": loss, **metrics}

    return train_step


def _serve_plan(cfg: ModelConfig, mesh):
    """``(rank-local config, keywords)`` of a serving step on ``mesh``:
    the plan ``Engine(mesh=)`` runs (``tensor_parallel(serve=True)``)."""
    tp = sharding.tensor_parallel(cfg, mesh, serve=True)
    return sharding.local_config(cfg, tp), ({} if tp is None else {"tp": tp})


def make_serve_step(cfg: ModelConfig, mesh=None):
    """One decode step: ``(params, cache, token) -> (logits, cache)``.
    With ``mesh``, each rank passes its shard of the parameters
    (``sharding.shard_params``) and its share of the cache (the family's
    ``init_cache`` on the rank-local config)."""
    fam = get_family(cfg)
    lcfg, kw = _serve_plan(cfg, mesh)

    def serve_step(params, cache, token):
        return fam.decode_step(params, cache, token, lcfg, **kw)

    return serve_step


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """``(params, batch, max_len=None) -> (cache, logits)``, with
    whisper's ``frames`` and a visual prefix passed on from the batch
    (``max_len``: the cache's capacity, the family's default by
    default).  With ``mesh``, each rank passes its shard of the
    parameters and its rows of the batch, and gets its share of the
    cache."""
    fam = get_family(cfg)
    lcfg, kw = _serve_plan(cfg, mesh)

    def prefill_step(params, batch, max_len=None):
        kwargs = {k: batch[k] for k in ("frames", "visual") if k in batch}
        return fam.prefill(params, batch["tokens"], lcfg, max_len=max_len, **kwargs, **kw)

    return prefill_step
