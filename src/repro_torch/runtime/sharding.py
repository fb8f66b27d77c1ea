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
* **rwkv6's ``cm_wr``** (``DIVERGENCES``).  The reference splits it on
  its output, but the channel mix multiplies ``sigmoid(cm_wr x)`` by
  ``cm_wv``'s row-parallel partial sum, so a split output would need a
  gather after the sum.  The port keeps ``cm_wr`` whole on every rank
  and all-reduces ``cm_wv``'s product, as an MLP's.

Beyond the table, what each rank executes (:func:`leaf_spec`): hymba's
``in_proj`` packs ``[xs | gate | B | C | dt]`` in its columns, and a rank
takes its SSM heads' share of ``xs``, ``gate`` and ``dt`` and the whole
of ``B`` and ``C`` (:class:`Segments`, not one contiguous slice).  Leaves
the table keeps whole but that feed split features (rwkv6's ``w0``,
``u``, ``wl_b``'s columns and ``ln_x``; hymba's ``A_log``, ``dt_bias``,
``D``, ``attn_norm`` and ``ssm_norm``) stay whole on every rank, and
the forward slices this rank's heads out of them; in training each rank
then holds a part of their gradient, and of the gradient of ``in_proj``'s
whole ``B`` and ``C``, which the train step all-reduces
(:func:`partial_grad_leaves`).

Caches: :func:`cache_specs` is the reference's (the sequence axis of KV
caches over ``"model"``), which the reference's dry run alone applies;
its serving engine places no linear cache and GSPMD follows the
head-split ``wk``/``wv``.  The port's engine splits every KV cache by
its KV heads (``(.., G, hd)``), as its paged arenas, and the recurrent
states by heads (``(L, B, H, ...)``): :func:`cache_split_leaves`; the
leaves whose ``"model"`` placement differs from ``cache_specs``' are
``CACHE_DIVERGENCES``.

:func:`filter_spec` replicates a dimension the mesh axis does not
divide, as the reference's does.  :func:`tensor_parallel` then decides
per group of leaves, on whole heads, experts and vocabulary rows (not on
flat features), whether the group splits; a group that does not split
replicates every leaf of it (:func:`shard_params`), and the forward
skips its collective.  Where ``"model"`` divides neither the KV heads
nor is there one KV head, a layer's attention runs whole on every rank.

The sequence layout (training only, ``tensor_parallel(seq=True)``)
places no leaf differently: it changes which activations a rank holds
(its positions of the residual, the gathered sequence inside a split
region) and so which leaves' gradients are partial
(:func:`partial_grad_leaves`).

Data parallelism (training): :func:`param_specs` with ``fsdp`` adds the
reference's ZeRO axis (:func:`_add_fsdp_axis`), :func:`batch_axes` and
:func:`batch_specs` split a batch's rows over ``("pod", "data")``, and
:func:`batch_rows` names the rows a rank holds, in the row-major order
of those axes.  :func:`param_shardings` gives each leaf its
:class:`NamedSharding`, the placement the port executes (the groups'
whole-head decisions included; with ``fsdp``, the ZeRO axis on the
leaf's whole shape, :func:`whole_shapes`), which ``Checkpointer.restore``
narrows a whole leaf by; :func:`shard_params` with ``fsdp`` cuts each
rank's pieces, which the FSDP train step runs on (:func:`fsdp_dims`).
On the unstacked leaves the ZeRO axis can land on another dim than the
reference's (``FSDP_DIVERGENCES``).

Serving's context-parallel prefill (:func:`context_parallel_prefill`)
places no leaf differently either: the attention's leaves stay whole on
every rank, as they do wherever its heads do not split.
"""
from __future__ import annotations

import dataclasses
import functools
import re

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.runtime.collectives import TensorParallel, gather_axis, gather_dim
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
    # rwkv (the channel mix's receptance whole: DIVERGENCES)
    (r"layers.*/cm_wr/w$", (None, None)),
    (r"layers.*/(wr|wk|wv|wg|cm_wk)/w$", (None, M)),
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
DIVERGENCES = (r"layers.*/wdq/w$", r"layers.*/wuq/w$", r"layers.*/cm_wr/w$")
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


def _entry_size(entry, sizes: dict):
    """The ranks a spec entry (an axis or a tuple of axes) spans, or
    ``None`` when the mesh lacks one of its axes."""
    names = entry if isinstance(entry, tuple) else (entry,)
    if any(a not in sizes for a in names):
        return None
    n = 1
    for a in names:
        n *= sizes[a]
    return n


def filter_spec(spec: tuple, shape, mesh) -> tuple:
    """Replicate any spec axis that the mesh lacks or whose size does
    not divide the dimension."""
    sizes = axis_sizes(mesh)
    dims = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for e, n in zip(dims, shape):
        k = None if e is None else _entry_size(e, sizes)
        out.append(e if k and n % k == 0 else None)
    return tuple(out)


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


def cache_specs(cache: dict, mesh, cfg: ModelConfig, *, seq_axis_shard: bool = False) -> dict:
    """The reference's specs of a linear KV or state cache: the sequence
    axis of K/V (``(L, B, T, G, hd)``) and of the MLA latents over
    ``"model"`` (with ``seq_axis_shard`` over ``("model", "data")``), the
    recurrent states (``wkv``, ``ssm``: ``(L, B, H, ...)``) by heads, the
    batch over ``("pod", "data")`` where it divides, the rest whole.
    The engine places its caches by heads (:func:`cache_split_leaves`)."""
    sizes = axis_sizes(mesh)
    t_axes = (M, D) if seq_axis_shard and D in sizes else M
    out = {}
    for key, x in cache.items():
        shape = tuple(x.shape) if isinstance(x, torch.Tensor) else ()
        nd = len(shape)
        if key == "len" or nd == 0:
            out[key] = ()
            continue
        b = batch_axes(shape[1], mesh) if nd > 1 else None
        if b is not None and len(b) == 1:       # one axis by its name, as a PartitionSpec
            b = b[0]
        if key in _KV_LEAVES:
            spec = (None, b, t_axes, None, None)
        elif key in ("c_kv", "k_rope"):
            spec = (None, b, t_axes, None)
        elif key in ("wkv", "ssm"):
            spec = (None, b, M, None, None)
        elif key in ("tm_x", "cm_x"):
            spec = (None, b, None)
        else:
            spec = (None,) * nd
        out[key] = filter_spec(spec, shape, mesh)
    return out


# K/V leaves (L, B, T, G, hd) of every family's linear cache (the paged
# arenas are (L, nb, bs, G, hd)): the engine splits their head axis
_KV_LEAVES = ("k", "v", "k_swa", "v_swa", "k_glb", "v_glb", "ck", "cv")
# the leaves whose "model" placement in the engine is not cache_specs'
# (ROADMAP.md, deliberate divergences): K/V by heads, not by sequence;
# MLA's latents whole, not by sequence
CACHE_DIVERGENCES = _KV_LEAVES + ("c_kv", "k_rope")


def cache_split_leaves(family: str, tp) -> tuple:
    """The cache leaves a rank of plan ``tp`` holds a share of, on their
    head axis: K/V where the KV heads split (never MLA's latents), the
    recurrent state where the heads split."""
    if tp is None:
        return ()
    kv = {"transformer": ("k", "v"), "hymba": ("k_swa", "v_swa", "k_glb", "v_glb"),
          "whisper": ("k", "v", "ck", "cv")}.get(family, ())
    state = {"hymba": ("ssm",), "rwkv6": ("wkv",)}.get(family, ())
    return (kv if tp.kv else ()) + (state if tp.attn else ())


# ---------------------------------------------------------------------------
# The tensor-parallel plan and each rank's shard
# ---------------------------------------------------------------------------

def _split_groups(cfg: ModelConfig, mp: int) -> dict:
    """Which groups of leaves split ``mp`` ways, decided on whole heads,
    experts and vocabulary rows.  ``attn`` is the attention's query
    heads (rwkv6: the time mix's heads and its state; hymba: the
    attention and SSM heads together, since ``_merge`` adds head i's
    features of both), ``kv`` its K/V heads, ``mlp`` the MLP's ``d_ff``
    (rwkv6: the channel mix's)."""
    h, g, fam = cfg.n_heads, cfg.n_kv_heads, cfg.family
    if fam == "rwkv6":
        attn, kv = h % mp == 0, False          # no KV cache
    elif cfg.mla:
        attn, kv = h % mp == 0, False          # the latent arena replicates
    else:
        kv = g % mp == 0
        attn = h % mp == 0 and (kv or g == 1)   # MQA: q heads only
        if fam == "hymba":
            attn = attn and cfg.ssm_heads % mp == 0
            kv = kv and attn
    return {"attn": attn, "kv": kv, "mlp": not cfg.is_moe and cfg.d_ff % mp == 0,
            "moe": cfg.is_moe and cfg.n_experts % mp == 0, "vocab": cfg.vocab % mp == 0}


def _group_of(path: str, cfg: ModelConfig):
    """The split group a leaf of ``cfg``'s family belongs to (None:
    never splits)."""
    if re.search(r"(tok_embed|lm_head/w)$", path):
        return "vocab"
    if cfg.family == "rwkv6":
        groups = ((r"layers/\d+/(wr|wk|wv|wg|wo)/w$", "attn"),
                  (r"layers/\d+/(cm_wk|cm_wv)/w$", "mlp"))
    elif cfg.family == "hymba":
        groups = ((r"layers/\d+/(wk|wv)/w$", "kv"),
                  (r"layers/\d+/(wq|in_proj|wo)/w$", "attn"),
                  (r"layers/\d+/mlp/(wi|wg|wo)/w$", "mlp"))
    else:              # the transformer; whisper's biases split with their columns
        groups = ((r"layers.*/(attn|self|cross)/(wk|wv)/[wb]$", "kv"),
                  (r"layers.*/(attn|self|cross)/(wq|wo|wuq|wuk|wuv)/[wb]$", "attn"),
                  (r"layers.*/mlp/(wi|wg|wo)/[wb]$", "mlp"),
                  (r"layers.*/moe/(wi|wg|wo)$", "moe"))
    for pat, group in groups:
        if re.search(pat, path):
            return group
    return None


def model_group(mesh):
    """The process group of the mesh's ``"model"`` axis and this rank's
    place in it: ``(group, rank, size)``."""
    return mesh.get_group(M), mesh.get_local_rank(M), mesh.size(
        mesh.mesh_dim_names.index(M))


# the families whose training forward reads ``seq_shard_activations``
SEQ_FAMILIES = ("transformer", "hymba")


def tensor_parallel(cfg: ModelConfig, mesh, seq: bool = False, serve: bool = False):
    """The rank's :class:`TensorParallel` plan on ``mesh`` for ``cfg``
    (any family), or ``None`` without a mesh or with a ``"model"`` axis
    of size 1: then every path is the single-device one.  ``seq`` (the
    training step passes ``cfg.seq_shard_activations``; serving never
    does) turns on the sequence layout in the families that have one
    (``SEQ_FAMILIES``): the transformer's residual holds a rank's
    positions between blocks (Megatron-SP), and an attention whose heads
    do not split is context-parallel there and in hymba.

    ``serve`` (the engine passes it) turns on context-parallel prefill
    (:func:`context_parallel_prefill`); the residual stays whole, as the
    reference's prefill has no sequence constraint."""
    if mesh is None or axis_sizes(mesh).get(M, 1) == 1:
        return None
    group, rank, size = model_group(mesh)
    groups = _split_groups(cfg, size)
    return TensorParallel(group=group, rank=rank, size=size, vocab_size=cfg.vocab,
                          n_experts=cfg.n_experts,
                          seq=bool(seq) and cfg.family in SEQ_FAMILIES,
                          cp=bool(serve) and context_parallel_prefill(cfg, size),
                          **groups)


def context_parallel_prefill(cfg: ModelConfig, mp: int) -> bool:
    """Whether serving's prefill attention is context-parallel at
    ``"model"`` ``mp``: the reference's ``_attn_context_parallel`` (q's
    sequence over ``"model"``, K/V replicated), which its engine reaches
    from the whole-prompt and the chunked prefill alike where the
    config's ``seq_shard_activations`` is set.  The port takes it in the
    transformer family (MLA included) where the attention's heads do not
    split (``_split_groups``' ``attn``): where they split, the head
    layout runs, which moves no activation.  Each rank then runs the
    attention of its contiguous share of the prompt's (or chunk's) query
    rows against the whole K/V, and the rows are gathered over
    ``"model"``.  hymba's prefill is a loop of decode steps that never
    reaches a whole-sequence attention, rwkv6 has no attention and
    whisper's config leaves the flag off: none of them takes it."""
    return (cfg.seq_shard_activations and cfg.family == "transformer" and mp > 1
            and not _split_groups(cfg, mp)["attn"])


def local_config(cfg: ModelConfig, tp) -> ModelConfig:
    """The rank-local config: the head counts (hymba's SSM heads too)
    and ``d_ff`` of this rank's shard (vocabulary and expert counts stay
    global: the logits are gathered to full width and every rank routes
    over every expert)."""
    if tp is None:
        return cfg
    n = tp.size
    over = dict(n_heads=cfg.n_heads // n if tp.attn else cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads // n if tp.kv else cfg.n_kv_heads,
                d_ff=cfg.d_ff // n if tp.mlp else cfg.d_ff)
    if cfg.family == "hymba" and tp.attn:
        over["ssm_heads"] = cfg.ssm_heads // n
    return dataclasses.replace(cfg, **over)


@dataclasses.dataclass(frozen=True)
class Segments:
    """A spec entry: a dim of whole segments ``sizes`` that splits over
    ``axis`` segment by segment, each segment where ``split`` says so
    into equal contiguous pieces, whole on every rank where it does not.
    A rank's share is its pieces in segment order (hymba's ``in_proj``
    columns ``[xs | gate | B | C | dt]``: xs, gate and dt by SSM heads,
    B and C whole)."""
    sizes: tuple
    split: tuple
    axis: str = M

    def local_size(self, n: int) -> int:
        return sum(s // n if sp else s for s, sp in zip(self.sizes, self.split))

    def pieces(self, x: torch.Tensor, dim: int, n: int) -> list:
        """A rank's share ``x`` (of ``n``) along ``dim`` as ``[(view,
        split)]``: runs of adjacent segments that split (this rank's
        pieces) or stay whole, in order."""
        runs, off = [], 0                  # [start, length, split]
        for s, sp in zip(self.sizes, self.split):
            k = s // n if sp else s
            if runs and runs[-1][2] == sp:
                runs[-1][1] += k
            else:
                runs.append([off, k, sp])
            off += k
        return [(x.narrow(dim, start, k), sp) for start, k, sp in runs]

    def take(self, x: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
        """Rank ``rank``'s share (of ``n``) of the whole ``x`` along ``dim``."""
        pieces, off = [], 0
        for s, sp in zip(self.sizes, self.split):
            k = s // n if sp else s
            pieces.append(x.narrow(dim, off + (rank * k if sp else 0), k))
            off += s
        return torch.cat(pieces, dim)

    def join(self, stacked: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole leaf from ``stacked`` (n, ...), every rank's share
        of it along ``dim`` (a whole segment from rank 0's)."""
        n, parts, off = stacked.shape[0], [], 0
        for s, sp in zip(self.sizes, self.split):
            k = s // n if sp else s
            piece = stacked.narrow(dim + 1, off, k)
            parts += list(piece.unbind(0)) if sp else [piece[0]]
            off += k
        return torch.cat(parts, dim)


def _in_proj_segments(cfg: ModelConfig) -> Segments:
    d_in = cfg.ssm_heads * cfg.ssm_head_dim
    n = cfg.ssm_state
    return Segments((d_in, d_in, n, n, cfg.ssm_heads), (True, True, False, False, True))


def leaf_spec(path: str, shape, mesh, cfg: ModelConfig) -> tuple:
    """A leaf's placement: the rule table's spec, filtered by
    divisibility, and replicated whole when its group does not split;
    hymba's ``in_proj`` columns by :class:`Segments`."""
    group = _group_of(path, cfg)
    mp = axis_sizes(mesh).get(M, 1)
    if group is None or not _split_groups(cfg, mp)[group]:
        return (None,) * len(shape)
    if cfg.family == "hymba" and re.search(r"in_proj/w$", path):
        return (None, _in_proj_segments(cfg))
    return filter_spec(spec_for_path(path, len(shape)), shape, mesh)


def _split_dim(spec: tuple):
    """``(dim, entry)`` of the spec's split dim (``"model"`` or
    :class:`Segments`), or ``(None, None)``."""
    for dim, e in enumerate(spec):
        if e == M or isinstance(e, Segments):
            return dim, e
    return None, None


def _local(x: torch.Tensor, spec: tuple, rank: int, size: int, global_shape) -> torch.Tensor:
    """The rank's share along the spec's split dim (a contiguous slice,
    or :class:`Segments`' pieces); a leaf already at its local size is
    kept."""
    dim, entry = _split_dim(spec)
    if dim is None:
        return x
    if isinstance(entry, Segments):
        n = entry.local_size(size)
        return x if x.shape[dim] == n else entry.take(x, dim, rank, size).contiguous()
    n = global_shape[dim] // size
    if x.shape[dim] == n:
        return x
    return x.narrow(dim, rank * n, n).contiguous()


def shard_params(params, mesh, cfg: ModelConfig, prefix: str = "", fsdp: bool = False):
    """This rank's local tensors of a parameter tree (or of the subtree
    at ``prefix``, e.g. ``layers/3``): a contiguous slice along each
    split leaf's ``"model"`` dim, the whole leaf where it replicates;
    with ``fsdp`` (the training step's ``cfg.fsdp``) and a ``"data"``
    axis > 1, then this rank's piece along the dim that ``"data"``
    splits (:func:`param_shardings`).  Idempotent: leaves already at
    their local shape stay as they are.  Identity without a mesh or
    with ``"model"`` (and under ``fsdp`` ``"data"``) of size 1."""
    if mesh is None:
        return params
    if tensor_parallel(cfg, mesh) is not None:
        _, rank, size = model_group(mesh)
        shapes = whole_shapes(cfg)

        def walk(t, path):
            if isinstance(t, dict):
                return {k: walk(v, f"{path}/{k}" if path else k) for k, v in t.items()}
            if isinstance(t, list):
                return [walk(v, f"{path}/{i}") for i, v in enumerate(t)]
            shape = _whole_leaf_shape(path, t.shape, shapes)
            return _local(t, leaf_spec(path, shape, mesh, cfg), rank, size, shape)
        params = walk(params, prefix)
    if not fsdp or axis_sizes(mesh).get(D, 1) == 1:
        return params
    place, shapes = _placer(mesh, cfg, True), whole_shapes(cfg)
    n = axis_sizes(mesh)[D]

    def piece(path, t):
        # this rank's piece along the dim "data" splits, where the leaf is
        # whole along it (the leaf itself where it splits nothing, or is a
        # piece already)
        spec = place(path, tuple(t.shape))
        if D not in spec:
            return t
        dim = spec.index(D)
        whole = _whole_leaf_shape(path, t.shape, shapes)[dim]
        if t.shape[dim] != whole:
            return t
        return t.narrow(dim, mesh.get_local_rank(D) * (whole // n), whole // n).contiguous()
    return _map_with_paths(piece, params, prefix)


# leaves every rank holds whole but uses a slice of (this rank's heads)
# where their group splits: each rank holds a part of their gradient
_PARTIAL = {
    "transformer": ((r"layers.*/moe/router/w$", "moe"),),
    "rwkv6": ((r"^layers/\d+/(w0|u|wl_b|ln_x/scale|ln_x/bias)$", "attn"),),
    "hymba": ((r"^layers/\d+/(A_log|dt_bias|D|attn_norm/scale|ssm_norm/scale)$", "attn"),),
}


# hymba's context-parallel attention branch (the sequence layout where
# its heads do not split): each rank's queries see every key
_HYMBA_CP = r"^layers/\d+/(wq/w|wk/w|wv/w|attn_norm/scale)$"


def partial_grad_leaves(params, cfg: ModelConfig, tp) -> list:
    """For each leaf (walk order): whether it is replicated but each rank
    holds only a part of its gradient, which must then be all-reduced
    over ``"model"`` before the update: ``True`` for the whole leaf,
    ``(dim, Segments)`` for the whole segments of a :class:`Segments`
    leaf (its split segments are this rank's own), else ``False``.  A
    leaf is partial only where its group splits: the MoE router (its
    gates meet only this rank's experts in the combine); rwkv6's
    ``w0``, ``u``, ``wl_b`` and ``ln_x``; hymba's ``A_log``, ``dt_bias``,
    ``D``, ``attn_norm``, ``ssm_norm`` and the ``B`` and ``C`` columns of
    ``in_proj`` (each sliced to this rank's heads, or feeding only
    them).  Every other replicated leaf sits outside the column-parallel
    regions (their inputs go through ``TensorParallel.enter``) and gets
    its whole gradient on every rank, rwkv6's ``cm_wr`` included: its
    input is replicated and its gate multiplies ``cm_wv``'s product
    after the all-reduce.

    Under the sequence layout (``tp.seq``) the transformer's every leaf
    that does not split is partial: the norms, an attention, MLP or MoE
    that does not split and the embedding and head over a whole
    vocabulary run on this rank's positions alone, and the whole leaves
    inside a split region (the router, MQA's ``wk``/``wv``, MLA's
    ``wdq``, ``q_norm``, ``wdkv`` and ``kv_norm``) on the gathered
    sequence for this rank's heads or experts alone.  Hymba keeps its
    residual whole; where its heads do not split, its context-parallel
    attention branch makes ``wq``, ``wk``, ``wv`` and ``attn_norm``
    partial (each rank's queries are its own positions')."""
    named = leaves_with_paths(params)
    if tp is None:
        return [False] * len(named)
    rules = _PARTIAL.get(cfg.family, ())
    if tp.seq and cfg.family == "hymba" and not tp.attn:
        rules = rules + ((_HYMBA_CP, "seq"),)

    def partial(path):
        if tp.seq and cfg.family == "transformer":
            group = _group_of(path, cfg)
            return group is None or not getattr(tp, group)
        if cfg.family == "hymba" and tp.attn and re.search(r"in_proj/w$", path):
            return (1, _in_proj_segments(cfg))
        return any(getattr(tp, group) and re.search(pat, path) for pat, group in rules)
    return [partial(p) for p, _ in named]


def split_leaves(params, cfg: ModelConfig, mesh) -> list:
    """For each leaf (walk order): ``True`` where it is split over
    ``"model"`` (each rank holds a slice; its squares sum over the group
    in the gradient norm), ``(dim, Segments)`` for a :class:`Segments`
    leaf (its split segments' squares sum over the group, its whole
    ones count once), else ``False``."""
    named = leaves_with_paths(params)
    if tensor_parallel(cfg, mesh) is None:
        return [False] * len(named)
    shapes = whole_shapes(cfg)

    def split(path, shape):
        dim, entry = _split_dim(leaf_spec(path, _whole_leaf_shape(path, shape, shapes),
                                          mesh, cfg))
        return (dim, entry) if isinstance(entry, Segments) else dim is not None
    return [split(p, x.shape) for p, x in named]


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

    def shard_shape(self, shape) -> tuple:
        """The shape of this placement's piece of a whole leaf of
        ``shape`` (the counterpart of ``jax.sharding.NamedSharding.
        shard_shape``); a :class:`Segments` dim takes its local size."""
        sizes = axis_sizes(self.mesh)
        out = []
        for n, axis in zip(shape, tuple(self.spec) + (None,) * (len(shape) - len(self.spec))):
            if isinstance(axis, Segments):
                n = axis.local_size(sizes[axis.axis])
            elif axis is not None:
                n = n // _entry_size(axis, sizes)
            out.append(n)
        return tuple(out)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            if isinstance(axis, Segments):
                x = axis.take(x, dim, self.mesh.get_local_rank(axis.axis),
                              axis_sizes(self.mesh)[axis.axis])
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
        if isinstance(axis, Segments):
            x = axis.join(gather_axis(x.contiguous(), sh.mesh, axis.axis, what="checkpoint"),
                          dim)
        elif axis is not None:
            x = gather_dim(x, dim, sh.mesh, axis)
    return x


def param_shardings(params, mesh, *, cfg: ModelConfig = None, fsdp: bool = False):
    """A tree of :class:`NamedSharding` shaped like ``params`` (or an
    optimizer state: the rules match its ``m/...`` and ``v/...`` paths
    too).  With ``cfg`` and a ``"model"`` axis that splits, each leaf
    gets the placement the port executes (``leaf_spec``, on its whole
    shape), so a rank's shard of a whole leaf is the one its model
    runs; otherwise the rule table's spec, filtered on the leaf's shape.
    ``fsdp`` (the reference's keyword; the training step passes
    ``cfg.fsdp``) with a ``"data"`` axis > 1 adds ``"data"`` on the dim
    :func:`_add_fsdp_axis` picks from the leaf's whole shape
    (:func:`whole_shapes` of ``cfg``, so ``params`` may hold whole
    leaves, a rank's shards or its FSDP pieces of any data size); a leaf
    that ``"data"`` divides nowhere stays replicated over it."""
    place = _placer(mesh, cfg, fsdp)
    return _map_with_paths(lambda path, leaf: NamedSharding(
        mesh, place(path, tuple(leaf.shape))), params)


def _placer(mesh, cfg, fsdp: bool):
    """``place(path, shape)``: :func:`param_shardings`' spec of a leaf."""
    tp = None if cfg is None else tensor_parallel(cfg, mesh)
    n_data = axis_sizes(mesh).get(D, 1) if fsdp else 1
    shapes = whole_shapes(cfg) if cfg is not None and (tp is not None or n_data > 1) else {}

    def place(path, shape):
        whole = _whole_leaf_shape(path, shape, shapes)
        if tp is not None:
            spec = leaf_spec(path, whole, mesh, cfg)
        else:
            spec = filter_spec(spec_for_path(path, len(shape)), shape, mesh)
        if n_data > 1:
            spec = _add_fsdp_axis(spec, whole, n_data)
        return spec
    return place


def ef_shardings(params, mesh, cfg: ModelConfig):
    """The error feedback's placements in the pod-compressed step, the
    counterpart of the reference dry run's ``_ef_shardings``: each
    residual, viewed globally as ``(n_pods, *leaf)``, is placed as
    ``("pod",) +`` its parameter's placement (:func:`param_shardings`
    with ``fsdp=cfg.fsdp``), so that a rank's residual is shaped like
    its parameter's piece (``gradient.init_error_state`` on the pieces).
    The reference always adds the ZeRO axis here (``fsdp=True``); where
    ``cfg.fsdp`` is off the port's rank holds the residual of its whole
    parameter, whole over ``"data"`` (ROADMAP.md, deliberate
    divergences).  No dim carries two axes."""
    def one(sh):
        if "pod" in sh.spec:
            raise ValueError(f"a parameter placed over 'pod' already: {sh.spec}")
        return NamedSharding(mesh, ("pod",) + tuple(sh.spec))
    return _map_with_paths(lambda path, sh: one(sh),
                           param_shardings(params, mesh, cfg=cfg, fsdp=cfg.fsdp))


def fsdp_dims(params, mesh, cfg: ModelConfig) -> list:
    """For each leaf of a rank's FSDP pieces ``params`` (walk order): the
    dim that ``"data"`` splits (:func:`param_shardings` with ``fsdp``),
    or ``None``.  Raises where a split leaf is not at its piece's size
    (a leaf that :func:`shard_params` with ``fsdp`` did not cut)."""
    shapes, n = whole_shapes(cfg), axis_sizes(mesh).get(D, 1)
    out = []
    for (path, x), (_, sh) in zip(leaves_with_paths(params),
                                  leaves_with_paths(param_shardings(params, mesh, cfg=cfg,
                                                                    fsdp=True))):
        dim = sh.spec.index(D) if D in sh.spec else None
        if dim is not None and x.shape[dim] * n != _whole_leaf_shape(path, x.shape,
                                                                     shapes)[dim]:
            raise ValueError(f"FSDP: {path} {tuple(x.shape)} is not this rank's piece "
                             "(sharding.shard_params with fsdp)")
        out.append(dim)
    return out


@functools.lru_cache(maxsize=None)
def whole_shapes(cfg: ModelConfig) -> dict:
    """``{path: shape}`` of every leaf of ``cfg``'s parameters, whole:
    the family's ``init_params`` run under ``FakeTensorMode`` (shapes
    alone: nothing is drawn or allocated; its imports cost a second or
    two once a process).  The one source of whole shapes for the
    ``"model"`` and the FSDP placements: neither a rank's shard nor an
    FSDP piece can name its whole leaf (a dim of 3 is a whole leaf's or
    half of 6's)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import get_family
    with FakeTensorMode():
        params = get_family(cfg).init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    return {path: tuple(x.shape) for path, x in leaves_with_paths(params)}


def _whole_leaf_shape(path: str, shape, shapes: dict) -> tuple:
    """The whole shape of the parameter whose path ends ``path`` (an
    optimizer state's ``m/...``, a state's ``params/...``), or
    ``shape`` where none does (``count``)."""
    parts = path.split("/")
    for i in range(len(parts)):
        hit = shapes.get("/".join(parts[i:]))
        if hit is not None:
            return hit
    return tuple(shape)


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
