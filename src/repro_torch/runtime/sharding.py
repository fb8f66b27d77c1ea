"""Tensor-parallel placement: the param-path rule table, the paged
cache's specs and each rank's shard of the weights.

The port of ``repro/runtime/sharding.py``.  A spec is a plain tuple with
one entry per dimension: ``"model"`` where the dimension splits over
the mesh's ``"model"`` axis, ``None`` where it replicates.  The rule
table is the reference's, first match wins, with two changes:

* **Unstacked paths.**  The port keeps per-layer parameter lists
  (``layers/3/attn/wq/w``), where the reference stacks every layer on
  axis 0 (``layers/attn/wq/w``).  So each rule on a per-layer leaf drops
  the reference's leading layer-stack axis; the four top-level rules
  (``tok_embed``, ``pos_embed``, ``meta_tokens``, ``lm_head/w``) are
  unchanged.
* **MLA's query path** (``DIVERGENCES``).  The reference splits ``wdq``
  on its output and ``wuq`` on its input; between them sits
  ``q_norm``, an RMS norm over the whole query latent.  The port keeps
  ``wdq`` (and ``q_norm``) whole on every rank and splits ``wuq`` by
  heads, so the query heads are rank-local with no collective.

:func:`filter_spec` replicates a dimension the mesh axis does not
divide, as the reference's does.  :func:`tensor_parallel` then decides
per group of leaves, on whole heads, experts and vocabulary rows (not on
flat features), whether the group splits; a group that does not split
replicates every leaf of it (:func:`shard_params`), and the forward
skips its collective.  Where ``"model"`` divides neither the KV heads
nor is there one KV head, a layer's attention runs whole on every rank.

Data parallelism (training): :func:`param_specs` with ``fsdp`` adds the
reference's ZeRO axis (:func:`_add_fsdp_axis`; a spec only, as the
reference's launcher runs no FSDP step either), :func:`batch_axes` and
:func:`batch_specs` split a batch's rows over ``("pod", "data")``, and
:func:`batch_rows` names the rows a rank holds, in the row-major order
of those axes.  :func:`param_shardings` gives each leaf its
:class:`NamedSharding`, the placement the port executes (the groups'
whole-head decisions included), which ``Checkpointer.restore`` narrows
a whole leaf by.  On the unstacked leaves the ZeRO axis can land on
another dim than the reference's (``FSDP_DIVERGENCES``).
"""
from __future__ import annotations

import dataclasses
import re

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.runtime.collectives import TensorParallel, gather_dim
from repro_torch.tree import leaves_with_paths

M, D = "model", "data"

# first match wins; paths look like "layers/3/attn/wq/w" or "tok_embed"
_TRANSFORMER_RULES = [
    (r"tok_embed$", (M, None)),
    (r"pos_embed$", (None, None)),
    (r"meta_tokens$", (None, None)),
    (r"lm_head/w$", (None, M)),
    # attention projections
    (r"layers.*/(wq|wk|wv)/w$", (None, M)),
    (r"layers.*/wo/w$", (M, None)),
    # MLA: the query latent whole, its up-projection by heads
    (r"layers.*/wdq/w$", (None, None)),
    (r"layers.*/wuq/w$", (None, M)),
    (r"layers.*/wdkv/w$", (None, None)),
    (r"layers.*/(wuk|wuv)/w$", (None, M)),
    # dense mlp
    (r"layers.*/mlp/(wi|wg)/w$", (None, M)),
    (r"layers.*/mlp/wo/w$", (M, None)),
    # moe (experts over 'model')
    (r"layers.*/moe/router/w$", (None, None)),
    (r"layers.*/moe/(wi|wg)$", (M, None, None)),
    (r"layers.*/moe/wo$", (M, None, None)),
    # rwkv
    (r"layers.*/(wr|wk|wv|wg|cm_wk|cm_wr)/w$", (None, M)),
    (r"layers.*/(cm_wv)/w$", (M, None)),
    (r"layers.*/tm_w1$", (None, None)),
    (r"layers.*/tm_w2$", (None, None, None)),
    (r"layers.*/wl_a$", (None, None)),
    (r"layers.*/wl_b$", (None, None)),
    # hymba ssm
    (r"layers.*/in_proj/w$", (None, M)),
    # whisper enc/dec stacks
    (r"(enc|dec)_layers.*/(wq|wk|wv)/w$", (None, M)),
    (r"(enc|dec)_layers.*/wo/w$", (M, None)),
    (r"(enc|dec)_layers.*/mlp/wi/w$", (None, M)),
    (r"(enc|dec)_layers.*/mlp/wo/w$", (M, None)),
    # projection biases: qkv/mlp-in biases shard with their matmul's
    # output features; wo biases add after the all-reduce, replicated
    (r"(wq|wk|wv|wg|wi)/b$", (M,)),
    (r"(wo|cm_wv)/b$", (None,)),
    # norms (scale/bias) are elementwise over the replicated residual
    (r"(ln[0-9]?|ln_x|ln_out|norm)/(scale|bias)$", (None,)),
    # rwkv mixing vectors + per-head decay/bonus, hymba ssm scalars
    (r"layers.*/(cm_maa_k|cm_maa_r|maa_x|w0|dt_bias|A_log|D)$", (None,)),
    (r"layers.*/maa_wkvrg$", (None, None)),
    (r"layers.*/u$", (None, None)),
]

# rules whose placement is not the reference's with its layer axis
# dropped (ROADMAP.md, deliberate divergences)
DIVERGENCES = (r"layers.*/wdq/w$", r"layers.*/wuq/w$")
# fsdp on a per-layer leaf (ROADMAP.md, deliberate divergences): the
# reference's stacked leaf takes "data" on its layer axis whenever the data
# size divides the layer count; the port's unstacked leaf has no layer axis,
# and ``_add_fsdp_axis`` takes its first free dim that the size divides
FSDP_DIVERGENCES = (r"^(layers|enc_layers|dec_layers)/\d+/",)


def match_for_path(path: str):
    """First rule matching ``path`` as ``(pattern, spec)``, or ``None``
    when no rule covers it (the leaf would silently replicate)."""
    for pat, spec in _TRANSFORMER_RULES:
        if re.search(pat, path):
            return pat, spec
    return None


def spec_for_path(path: str, ndim: int) -> tuple:
    """The rule's spec, or all ``None`` when no rule matches or the
    rule's rank is not the leaf's."""
    hit = match_for_path(path)
    if hit is not None and len(hit[1]) == ndim:
        return hit[1]
    return (None,) * ndim


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of anything with
    ``axis_names`` and a ``shape`` mapping, such as a test's stand-in)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


def filter_spec(spec: tuple, shape, mesh) -> tuple:
    """Replicate any spec axis that the mesh lacks or whose size does
    not divide the dimension."""
    sizes = axis_sizes(mesh)
    dims = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(e if e is not None and e in sizes and n % sizes[e] == 0 else None
                 for e, n in zip(dims, shape))


def paged_cache_specs(cache: dict, mesh, cfg: ModelConfig) -> dict:
    """Specs of a paged pool cache's leaves: the dense arenas ``k``/``v``
    (L, nb, bs, G, hd) split their head axis; the MLA latents (no head
    axis) and the metadata (``block_tables``, ``lens``, the Python-int
    ``max_len``) replicate.  One block id therefore names one slice on
    every rank, and the host-side block pool stays rank-agnostic."""
    out = {}
    for key, x in cache.items():
        shape = tuple(x.shape) if isinstance(x, torch.Tensor) else ()
        spec = (None, None, None, M, None) if key in ("k", "v") and len(shape) == 5 \
            else (None,) * len(shape)
        out[key] = filter_spec(spec, shape, mesh)
    return out


# ---------------------------------------------------------------------------
# The tensor-parallel plan and each rank's shard
# ---------------------------------------------------------------------------

def _split_groups(cfg: ModelConfig, mp: int) -> dict:
    """Which groups of leaves split ``mp`` ways, decided on whole heads,
    experts and vocabulary rows."""
    h, g = cfg.n_heads, cfg.n_kv_heads
    if cfg.mla:
        attn, kv = h % mp == 0, False          # the latent arena replicates
    else:
        kv = g % mp == 0
        attn = h % mp == 0 and (kv or g == 1)   # MQA: q heads only
    return {"attn": attn, "kv": kv, "mlp": not cfg.is_moe and cfg.d_ff % mp == 0,
            "moe": cfg.is_moe and cfg.n_experts % mp == 0, "vocab": cfg.vocab % mp == 0}


def _group_of(path: str):
    """The split group a leaf belongs to (None: never splits)."""
    if re.search(r"(tok_embed|lm_head/w)$", path):
        return "vocab"
    if re.search(r"layers.*/attn/(wk|wv)/w$", path):
        return "kv"
    if re.search(r"layers.*/attn/(wq|wo|wuq|wuk|wuv)/w$", path):
        return "attn"
    if re.search(r"layers.*/mlp/(wi|wg|wo)/w$", path):
        return "mlp"
    if re.search(r"layers.*/moe/(wi|wg|wo)$", path):
        return "moe"
    return None


def model_group(mesh):
    """The process group of the mesh's ``"model"`` axis and this rank's
    place in it: ``(group, rank, size)``."""
    return mesh.get_group(M), mesh.get_local_rank(M), mesh.size(
        mesh.mesh_dim_names.index(M))


def tensor_parallel(cfg: ModelConfig, mesh):
    """The rank's :class:`TensorParallel` plan on ``mesh`` for ``cfg``,
    or ``None`` without a mesh or with a ``"model"`` axis of size 1 (for
    every family): then every path is the single-device one.  A larger
    ``"model"`` axis covers the transformer family only."""
    if mesh is None or axis_sizes(mesh).get(M, 1) == 1:
        return None
    if cfg.family != "transformer":
        raise NotImplementedError(
            f"tensor parallelism (serving and training) covers the transformer "
            f"family only (got {cfg.family!r} at 'model' "
            f"{axis_sizes(mesh)[M]}; ROADMAP.md Queue 1 item 6)")
    group, rank, size = model_group(mesh)
    return TensorParallel(group=group, rank=rank, size=size, vocab_size=cfg.vocab,
                          n_experts=cfg.n_experts, **_split_groups(cfg, size))


def local_config(cfg: ModelConfig, tp) -> ModelConfig:
    """The rank-local config: the head counts and ``d_ff`` of this rank's
    shard (vocabulary and expert counts stay global: the logits are
    gathered to full width and every rank routes over every expert)."""
    if tp is None:
        return cfg
    n = tp.size
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // n if tp.attn else cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads // n if tp.kv else cfg.n_kv_heads,
        d_ff=cfg.d_ff // n if tp.mlp else cfg.d_ff)


def leaf_spec(path: str, shape, mesh, cfg: ModelConfig) -> tuple:
    """A leaf's placement: the rule table's spec, filtered by
    divisibility, and replicated whole when its group does not split."""
    spec = filter_spec(spec_for_path(path, len(shape)), shape, mesh)
    group = _group_of(path)
    mp = axis_sizes(mesh).get(M, 1)
    if group is None or not _split_groups(cfg, mp)[group]:
        return (None,) * len(shape)
    return spec


def _local(x: torch.Tensor, spec: tuple, rank: int, size: int, global_shape) -> torch.Tensor:
    """The rank's contiguous slice along the spec's ``"model"`` dim; a
    leaf already at its local size is kept."""
    if M not in spec:
        return x
    dim = spec.index(M)
    n = global_shape[dim] // size
    if x.shape[dim] == n:
        return x
    return x.narrow(dim, rank * n, n).contiguous()


def shard_params(params, mesh, cfg: ModelConfig, prefix: str = ""):
    """This rank's local tensors of a parameter tree (or of the subtree
    at ``prefix``, e.g. ``layers/3``): a contiguous slice along each
    split leaf's ``"model"`` dim, the whole leaf where it replicates.
    Idempotent: leaves already at their local shape stay as they are.
    Identity without a mesh or with a ``"model"`` axis of size 1."""
    if tensor_parallel(cfg, mesh) is None:
        return params
    _, rank, size = model_group(mesh)
    glob = _global_shapes(cfg)

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}" if path else k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(t)]
        shape = glob.get(re.sub(r"/\d+/", "/", path), tuple(t.shape))
        return _local(t, leaf_spec(path, shape, mesh, cfg), rank, size, shape)
    return walk(params, prefix)


def _global_shapes(cfg: ModelConfig) -> dict:
    """Global leaf shapes of the transformer's parameters, keyed by path
    with the layer index removed (``layers/attn/wq/w``)."""
    d, h, g, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {"tok_embed": (cfg.vocab, d), "lm_head/w": (d, cfg.vocab)}
    if cfg.mla:
        qh = cfg.qk_nope_dim + cfg.qk_rope_dim
        out.update({"layers/attn/wuq/w": (cfg.q_lora_rank, h * qh),
                    "layers/attn/wuk/w": (cfg.kv_lora_rank, h * cfg.qk_nope_dim),
                    "layers/attn/wuv/w": (cfg.kv_lora_rank, h * cfg.v_head_dim),
                    "layers/attn/wo/w": (h * cfg.v_head_dim, d)})
    else:
        out.update({"layers/attn/wq/w": (d, h * hd), "layers/attn/wk/w": (d, g * hd),
                    "layers/attn/wv/w": (d, g * hd), "layers/attn/wo/w": (h * hd, d)})
    f, e, fe = cfg.d_ff, cfg.n_experts, cfg.d_ff_expert
    out.update({"layers/mlp/wi/w": (d, f), "layers/mlp/wg/w": (d, f),
                "layers/mlp/wo/w": (f, d), "layers/moe/wi": (e, d, fe),
                "layers/moe/wg": (e, d, fe), "layers/moe/wo": (e, fe, d)})
    return out



def partial_grad_leaves(params, tp) -> list:
    """For each leaf (walk order): whether it is replicated but each rank
    holds only a part of its gradient, which must then be all-reduced
    over ``"model"`` before the update.  The MoE router is the one: its
    gates meet only this rank's experts in the combine.  Every other
    replicated leaf sits outside the column-parallel regions (their
    inputs go through ``TensorParallel.enter``) and gets its whole
    gradient on every rank."""
    paths = [p for p, _ in leaves_with_paths(params)]
    if tp is None:
        return [False] * len(paths)
    return [bool(tp.moe and re.search(r"layers.*/moe/router/w$", p)) for p in paths]


def split_leaves(params, cfg: ModelConfig, mesh) -> list:
    """For each leaf (walk order): whether it is split over ``"model"``
    (each rank holds a slice; its squares sum over the group in the
    gradient norm)."""
    named = leaves_with_paths(params)
    if tensor_parallel(cfg, mesh) is None:
        return [False] * len(named)
    glob = _global_shapes(cfg)
    return [M in leaf_spec(p, _global_shape(p, x.shape, glob), mesh, cfg) for p, x in named]


# ---------------------------------------------------------------------------
# Data parallelism: the ZeRO axis, batches over ("pod", "data")
# ---------------------------------------------------------------------------

def _add_fsdp_axis(spec: tuple, shape, n_data: int) -> tuple:
    """ZeRO/FSDP: also split a leaf (and so its optimizer state) over
    ``"data"`` on the first unsplit dim that ``n_data`` divides."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    for i, (d, n) in enumerate(zip(dims, shape)):
        if d is None and n % n_data == 0 and n >= n_data:
            dims[i] = D
            return tuple(dims)
    return tuple(spec)


def param_specs(params, mesh=None, *, fsdp: bool = False, n_data: int = 1):
    """A tree of specs shaped like ``params``: the rule table's, filtered
    by ``mesh`` when given, with the ZeRO axis under ``fsdp``."""
    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = spec_for_path(path, len(shape))
        if mesh is not None:
            spec = filter_spec(spec, shape, mesh)
        if fsdp and n_data > 1:
            spec = _add_fsdp_axis(spec, shape, n_data)
        return spec
    return _map_with_paths(one, params)


def _map_with_paths(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement on a mesh: ``spec`` names, per dimension, the
    mesh axis that splits it (``None``: replicated).  :meth:`shard`
    takes this rank's piece of the whole leaf."""
    mesh: object
    spec: tuple

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            if not isinstance(axis, str):
                raise NotImplementedError(f"a dim split over several axes: {axis}")
            size = axis_sizes(self.mesh)[axis]
            n = x.shape[dim] // size
            x = x.narrow(dim, self.mesh.get_local_rank(axis) * n, n)
        return x.contiguous()


def unshard(x: torch.Tensor, sh) -> torch.Tensor:
    """A leaf whole: this rank's piece ``x`` gathered, bit for bit, along
    each dim its :class:`NamedSharding` ``sh`` splits (``None``: ``x``
    is whole already).  Every rank of the axes must call it."""
    if sh is None:
        return x
    for dim, axis in enumerate(sh.spec):
        if axis is not None:
            x = gather_dim(x, dim, sh.mesh, axis)
    return x


def _global_shape(path: str, shape, glob: dict) -> tuple:
    """A transformer leaf's whole shape from ``_global_shapes`` (its
    path with the layer index and any prefix such as ``m/`` dropped), or
    ``shape`` itself."""
    bare = re.sub(r"/\d+/", "/", path)
    for key, full in glob.items():
        if bare == key or bare.endswith("/" + key):
            return tuple(full)
    return tuple(shape)


def param_shardings(params, mesh, *, cfg: ModelConfig = None):
    """A tree of :class:`NamedSharding` shaped like ``params`` (or an
    optimizer state: the rules match its ``m/...`` and ``v/...`` paths
    too).  With ``cfg`` and a ``"model"`` axis that splits, each leaf
    gets the placement the port executes (``leaf_spec``, on its whole
    shape), so a rank's shard of a whole leaf is the one its model
    runs; otherwise the rule table's spec, filtered on the leaf's shape.
    No leaf splits over ``"data"``: the port executes no FSDP step
    (ROADMAP.md Queue 1 item 6)."""
    tp = None if cfg is None else tensor_parallel(cfg, mesh)
    glob = _global_shapes(cfg) if tp is not None else {}

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if tp is not None:
            spec = leaf_spec(path, _global_shape(path, shape, glob), mesh, cfg)
        else:
            spec = filter_spec(spec_for_path(path, len(shape)), shape, mesh)
        return NamedSharding(mesh, spec)
    return _map_with_paths(one, params)


def batch_axes(global_batch: int, mesh, axes=("pod", D)):
    """The ``axes`` (by default ``("pod", "data")``) in ``mesh`` when
    their product (> 1) divides ``global_batch``, else ``None``
    (replicated: every rank holds the whole batch)."""
    sizes = axis_sizes(mesh)
    present = tuple(a for a in axes if a in sizes)
    n = 1
    for a in present:
        n *= sizes[a]
    if n > 1 and global_batch % n == 0:
        return present
    return None


def batch_specs(batch, mesh) -> dict:
    """Specs of a batch's leaves ``{"tokens": (B, S), ...}``: the rows
    over :func:`batch_axes`, the rest replicated."""
    return {k: (batch_axes(v.shape[0], mesh),) + (None,) * (len(v.shape) - 1)
            for k, v in batch.items()}


def batch_rows(global_batch: int, mesh, axes=("pod", D)) -> tuple:
    """``(start, stop)``: the rows of a ``global_batch`` that this rank
    holds where :func:`batch_axes` splits them over ``axes`` (the whole
    batch where it replicates), rank-ordered row-major over the axes."""
    split = batch_axes(global_batch, mesh, axes)
    if split is None:
        return 0, global_batch
    sizes = axis_sizes(mesh)
    n, idx = 1, 0
    for a in split:
        n *= sizes[a]
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    per = global_batch // n
    return idx * per, (idx + 1) * per


def batch_slice(batch: dict, mesh) -> dict:
    """This rank's rows of every leaf of ``batch`` (:func:`batch_rows`)."""
    b = next(iter(batch.values())).shape[0]
    r0, r1 = batch_rows(b, mesh)
    return {k: v[r0:r1] for k, v in batch.items()}
