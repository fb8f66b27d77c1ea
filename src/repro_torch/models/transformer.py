"""Decoder-only transformer LM (dense GQA, sliding-window and MLA
attention) on linear and paged KV caches.

The port of ``repro/models/transformer.py``: ``init_params`` (f32 master
weights with ``dtype=torch.float32``); ``train_loss`` (the chunked
vocabulary loss, each layer rematerialised in the backward pass under
``cfg.remat == "layer"``) and ``logits_fn``; the whole-prompt
``prefill`` (ragged left-padded batches) into a linear cache
(``init_cache``: (L, B, T, ...) leaves with one shared write frontier, a
ring of the window's size on the window lane) or into the paged arena
(``block_tables=``); ``prefill_chunk`` (chunked prefill through the
paged cache); and ``decode_step`` on either layout. Layers run in a
Python loop over a list of per-layer parameter dicts (the reference
scans stacked parameters). Cache leaves stay stacked, (L, n_blocks,
block_size, G, D) arenas or (L, B, T, G, D) linear leaves for K/V, and
the MLA latents ``c_kv``/``k_rope`` the same way without the head axis;
they are updated in place and each function returns the cache dict with
the new ``lens`` (and ``len``). The feed-forward is the dense MLP or, on
a MoE config, ``layers.moe`` (row-local capacity dispatch over every
position a call passes); a config with visual tokens takes ``visual``
patch embeddings at the front of a whole-prompt prefill.

KV writes have one destination form, :func:`_write_kv`: rows to flat
slots of a layer's leaf seen as an arena (a linear leaf (B, T, ...) is
B blocks of T slots), -1 dropped.  On posit KV it is the fused write
kernel (``posit_codec.paged_write``: one launch per decode layer for
both leaves, one per arena leaf for a prefill chunk's layers, dropped
writes skipped on the device); f32/bf16 KV casts and scatters to the
same slots.  The whole-prompt prefill quantizes each layer's KV through
the codec (``posit_codec.quantize``); the linear decode lanes
dequantize the whole cache every step, as the reference does, a layer's
two leaves in one launch (``posit_codec.dequantize_many``); the
chunked-prefill arena read is one fused launch a layer; paged decode
attention runs the fused kernel (dense/window or
MLA latent) or the gather path (``cfg.paged_attn_kernel``).

Tensor-parallel serving: ``prefill``, ``prefill_chunk`` and the decode
steps (paged and linear) take ``tp`` (``runtime/collectives.
TensorParallel``) and run on the rank-local config (``sharding.
local_config``: this rank's heads and ``d_ff``) over this rank's shard
of the weights and of the cache (K/V by KV heads; MQA's one KV head and
MLA's latents whole on every rank);
``tp`` adds the all-reduces after attention's ``wo`` and the
feed-forward, the vocabulary-parallel embedding and the gathered logits.
With ``tp=None`` nothing changes.  Context-parallel prefill (``tp.cp``:
the engine's plan where ``seq_shard_activations`` is set and the
attention's heads do not split, the reference's ``_attn_context_parallel``
in its prefills): ``prefill`` and ``prefill_chunk`` run each rank's
contiguous share of the prompt's or chunk's query rows (padded up to a
multiple of ``"model"``, the pad rows dropped) against the K/V of every
row, which each rank computes and stores whole, and gather the rows'
outputs over ``"model"`` (:func:`_cp_project`); norms, residual and the
feed-forward stay whole, and decode is unchanged.

Tensor-parallel training: ``train_loss`` takes ``tp`` too and runs the
same blocks under autograd.  Each column-parallel region's input goes
through ``tp.enter`` (identity forward, all-reduce backward): the
input of ``wq``/``wk``/``wv`` (MQA: ``wq``'s, then the whole K and V, which
every rank's heads read), MLA's query latent, KV latent and RoPE key,
the MLP's and the MoE's input, and the head's; the row-parallel sums
(``tp.reduce``) pass the gradient through.  The loss over a split
vocabulary is vocabulary-parallel (``layers.chunked_xent``).

The sequence layout (``tp.seq``: ``make_train_step(mesh=)`` on a config
with ``seq_shard_activations``, the reference's ``_sp_constraint`` and
``_attn_context_parallel`` as explicit collectives): between blocks a
rank holds its contiguous ``S/size`` positions of the residual (B,
S/size, D), and ``ln1``, ``ln2`` and ``final_norm`` run on them.  A
region that splits takes ``tp.seq_gather`` of its input in place of
``enter`` and ends in ``tp.seq_scatter`` in place of ``reduce``: the
attention where its heads split, the MLP where ``d_ff`` does, the
vocabulary-parallel embedding (a masked lookup of every position) and
head.  An attention whose heads do not split is context-parallel: the
queries of the rank's positions against the keys and values of the
whole sequence (``ln1``'s output gathered), the causal mask and window
on absolute positions, ``wo`` on the rank's positions.  An MLP that
does not split, the embedding and the loss over a whole vocabulary run
on the rank's positions alone.  A MoE layer always routes the whole
sequence (its capacity and drop order are the whole call's): it takes
the gathered input and ends in ``seq_scatter`` where its experts split,
in ``seq_slice`` where they do not.
"""
from __future__ import annotations

import torch

from repro_torch.core import types as PT
from repro_torch.device import resolve_device
from repro_torch.kernels import posit_codec
from . import layers as L
from .config import ModelConfig


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_attention(gen, cfg: ModelConfig, dt, dev):
    d = cfg.d_model
    if cfg.mla:
        qh = cfg.qk_nope_dim + cfg.qk_rope_dim
        return {
            "wdq": L.init_dense(gen, d, cfg.q_lora_rank, dtype=dt),
            "q_norm": L.init_rms_norm(cfg.q_lora_rank, cfg, dev),
            "wuq": L.init_dense(gen, cfg.q_lora_rank, cfg.n_heads * qh,
                                dtype=dt),
            "wdkv": L.init_dense(gen, d, cfg.kv_lora_rank + cfg.qk_rope_dim,
                                 dtype=dt),
            "kv_norm": L.init_rms_norm(cfg.kv_lora_rank, cfg, dev),
            "wuk": L.init_dense(gen, cfg.kv_lora_rank,
                                cfg.n_heads * cfg.qk_nope_dim, dtype=dt),
            "wuv": L.init_dense(gen, cfg.kv_lora_rank,
                                cfg.n_heads * cfg.v_head_dim, dtype=dt),
            "wo": L.init_dense(gen, cfg.n_heads * cfg.v_head_dim, d,
                               dtype=dt),
        }
    return {
        "wq": L.init_dense(gen, d, cfg.n_heads * cfg.head_dim, dtype=dt),
        "wk": L.init_dense(gen, d, cfg.n_kv_heads * cfg.head_dim, dtype=dt),
        "wv": L.init_dense(gen, d, cfg.n_kv_heads * cfg.head_dim, dtype=dt),
        "wo": L.init_dense(gen, cfg.n_heads * cfg.head_dim, d, dtype=dt),
    }


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda", dtype=None,
                shard=None):
    """Random parameters from a seeded ``torch.Generator`` on ``device``.

    Every 2-D weight and the embedding are drawn in f32 and stored in
    ``dtype``, by default the compute dtype (the forward casts them to
    it anyway); training passes ``torch.float32`` for f32 master
    weights.  Norm scales stay f32.  ``params["layers"]`` is a list of
    per-layer dicts.

    ``shard(subtree, prefix)`` (tensor-parallel serving, e.g.
    ``sharding.shard_params`` on the rank's mesh) cuts each layer and
    each top-level leaf to this rank's shard as soon as it is drawn, so
    the rank holds one layer whole at most; every rank draws the same
    stream, so the shards are those of the single-device weights.
    """
    keep = shard or (lambda t, prefix: t)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    dt = L.cdtype(cfg) if dtype is None else dtype
    d = cfg.d_model
    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "ln1": L.init_rms_norm(d, cfg, dev),
            "attn": _init_attention(gen, cfg, dt, dev),
            "ln2": L.init_rms_norm(d, cfg, dev),
        }
        if cfg.is_moe:
            layer["moe"] = L.init_moe(gen, cfg, dtype=dt)
        else:
            layer["mlp"] = L.init_mlp(gen, cfg, dtype=dt)
        layers.append(keep(layer, f"layers/{len(layers)}"))
    embed = torch.randn((cfg.vocab, d), generator=gen, device=dev,
                        dtype=torch.float32) * 0.02
    params = {
        "tok_embed": keep(embed.to(dt), "tok_embed"),
        "layers": layers,
        "final_norm": L.init_rms_norm(d, cfg, dev),
    }
    del embed
    if not cfg.tie_embeddings:
        params["lm_head"] = keep(L.init_dense(gen, d, cfg.vocab, dtype=dt), "lm_head")
    return params


def _embed(params, tokens, cfg: ModelConfig, visual=None, tp=None):
    """Token embeddings (B, S, D); with ``visual`` (B, nv, D) on a config
    with visual tokens, the patch embeddings take the front of the
    sequence and the prompt's last nv embeddings drop, so the length
    stays S (the reference's stub prefix).  Under a tensor-parallel plan
    ``tp`` the lookup is vocabulary-parallel (``collectives``); under its
    sequence layout, this rank's positions (:func:`_embed_seq`)."""
    table = params["tok_embed"]
    if tp is not None and tp.seq:
        return _embed_seq(table, tokens, cfg, visual, tp)
    x = (table[tokens] if tp is None else tp.embed(table, tokens)).to(L.cdtype(cfg))
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if cfg.n_visual_tokens and visual is not None:
        nv = cfg.n_visual_tokens
        x = torch.cat([visual.to(x.dtype), x[:, :x.shape[1] - nv]], dim=1)
    return x


def _embed_seq(table, tokens, cfg: ModelConfig, visual, tp):
    """:func:`_embed`'s sequence at this rank's positions (B, S/size, D):
    over a split vocabulary, every position's masked lookup of this
    rank's rows reduce-scattered; over a whole one, the lookup of the
    rank's own positions.  The visual prefix then takes the front."""
    s = tokens.shape[1]
    p0, n = tp.positions(s)
    nv = cfg.n_visual_tokens if cfg.n_visual_tokens and visual is not None else 0
    src = (torch.arange(s, device=tokens.device) - nv).clamp(min=0)   # each position's token
    if tp.vocab:
        x = tp.seq_scatter(tp._vocab_rows(table, tokens[:, src]))
    else:
        x = table[tokens[:, src[p0:p0 + n]]]
    x = x.to(L.cdtype(cfg))
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    front = min(max(nv - p0, 0), n)
    if front:
        x = torch.cat([visual[:, p0:p0 + front].to(x.dtype), x[:, front:]], dim=1)
    return x


def _unembed_weight(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["tok_embed"].T
    return L.maybe_dequant(params["lm_head"]["w"], cfg)


def _logits(params, x, cfg: ModelConfig, tp=None):
    """(..., D) final hidden states -> (..., V) f32 logits; under ``tp``
    this rank's vocabulary columns gathered to full width."""
    y = x @ _unembed_weight(params, cfg).to(x.dtype)
    return y.to(torch.float32) if tp is None else tp.gather_vocab(y)


def _row_parallel(y, tp, group: str):
    """A product's partial sum over this rank's share of ``group``
    (``"attn"``, ``"mlp"``, ``"moe"``), all-reduced under ``tp`` when
    that group splits; else ``y`` itself."""
    return tp.reduce(y) if tp is not None and getattr(tp, group) else y


def _enter(x, tp, group: str):
    """``x`` as the input of ``group``'s column-parallel products: its
    gradient all-reduced under ``tp`` when that group splits."""
    return tp.enter(x) if tp is not None and getattr(tp, group) else x


def _block_mlp(lp, h, cfg: ModelConfig, tp=None):
    """The feed-forward half of a block, dense or MoE (every position of
    ``h`` routes, whatever its validity); under ``tp`` this rank's
    ``d_ff`` columns or experts, then the all-reduce (under the sequence
    layout, :func:`_ff_seq`)."""
    hn = L.rms_norm(lp["ln2"], h, cfg)
    if tp is not None and tp.seq:
        return h + _ff_seq(lp, hn, cfg, tp)
    if cfg.is_moe:
        experts = None if tp is None else tp.expert_slice()
        return h + _row_parallel(L.moe(lp["moe"], _enter(hn, tp, "moe"), cfg,
                                       experts=experts), tp, "moe")
    return h + _row_parallel(L.mlp(lp["mlp"], _enter(hn, tp, "mlp"), cfg), tp, "mlp")


def _ff_seq(lp, hn, cfg: ModelConfig, tp):
    """The feed-forward under the sequence layout, ``hn`` this rank's
    positions: a MoE routes the gathered whole sequence (its capacity is
    the whole call's) and keeps this rank's positions of the sum over
    the experts' ranks, or of its own whole sum; a split MLP runs its
    columns over the gathered sequence, reduce-scattered; a whole one
    runs on the rank's positions."""
    if cfg.is_moe:
        y = L.moe(lp["moe"], tp.seq_gather(hn), cfg, experts=tp.expert_slice())
        return tp.seq_scatter(y) if tp.moe else tp.seq_slice(y)
    if tp.mlp:
        return tp.seq_scatter(L.mlp(lp["mlp"], tp.seq_gather(hn), cfg))
    return L.mlp(lp["mlp"], hn, cfg)


# ---------------------------------------------------------------------------
# Whole-prompt attention (the unchunked prefill)
# ---------------------------------------------------------------------------

def _attn_forward(p, x, positions, cfg: ModelConfig, kv_mask, tp=None, q_rows=None,
                  project=True):
    """Causal self-attention over a whole (left-padded) prompt.  RoPE
    takes ``positions`` (B, S) (row-relative, negative on pad tokens);
    the causal mask runs on the padded coordinates and ``kv_mask``
    (B, S) drops each row's pad keys.  Returns ``(out, (K, V))`` with
    the layer's fresh KV (MLA: the latent and its RoPE key).
    ``q_rows`` (context parallelism): ``(xq, q_positions, q_rope)``, the
    queries' own rows (B, Sq, D), their padded coordinates (B, Sq) and
    their RoPE positions (B, Sq), against the keys and values of the
    whole ``x``; ``out`` is then the queries' (B, Sq, D).  ``project``
    false returns ``out`` before ``wo`` (B, Sq, H dv)."""
    b, s, _ = x.shape
    if q_rows is None:
        ar = torch.arange(s, device=x.device)[None, :].expand(b, s)
        xq_in, q_pos, q_rope_pos = x, ar, positions
    else:
        xq_in, q_pos, q_rope_pos = q_rows
    sq = xq_in.shape[1]
    out_of = (lambda o: _wo(p, o, cfg, tp)) if project else (lambda o: o)
    if cfg.mla:
        h, nope, rope = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
        q_lat = L.rms_norm(p["q_norm"], L.dense(p["wdq"], xq_in, cfg), cfg)
        q = L.dense(p["wuq"], _enter(q_lat, tp, "attn"), cfg).reshape(b, sq, h, nope + rope)
        q_nope, q_rope = q.split([nope, rope], dim=-1)
        q = torch.cat([q_nope, L.apply_rope(q_rope, q_rope_pos, cfg.rope_theta)], -1)
        c_kv, k_rope = L.dense(p["wdkv"], x, cfg).split([cfg.kv_lora_rank, rope], dim=-1)
        c_kv = L.rms_norm(p["kv_norm"], c_kv, cfg)
        k_rope = L.apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
        c_in = _enter(c_kv, tp, "attn")
        k_nope = L.dense(p["wuk"], c_in, cfg).reshape(b, s, h, nope)
        v = L.dense(p["wuv"], c_in, cfg).reshape(b, s, h, cfg.v_head_dim)
        k = torch.cat([k_nope, _enter(k_rope, tp, "attn").expand(b, s, h, rope)], -1)
        out = L.flash_attention(q, k, v, causal=True, cfg=cfg, kv_mask=kv_mask,
                                q_positions=q_pos)
        out = out.reshape(b, sq, h * cfg.v_head_dim)
        return out_of(out), (c_kv, k_rope[:, :, 0, :])
    xq = _enter(xq_in, tp, "attn")
    xkv = xq if tp is not None and tp.kv else x
    q = L.dense(p["wq"], xq, cfg).reshape(b, sq, cfg.n_heads, cfg.head_dim)
    k = L.dense(p["wk"], xkv, cfg).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = L.dense(p["wv"], xkv, cfg).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if tp is not None and tp.attn and not tp.kv:       # MQA: every rank's heads read K, V
        k, v = tp.enter(k), tp.enter(v)
    q = L.apply_rope(q, q_rope_pos, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    out = L.flash_attention(q, k, v, causal=True, cfg=cfg, kv_mask=kv_mask,
                            q_positions=q_pos, window=cfg.sliding_window)
    out = out.reshape(b, sq, cfg.n_heads * cfg.head_dim)
    return out_of(out), (k, v)


def _attn_cp(p, hn, positions, cfg: ModelConfig, kv_mask, tp):
    """Context-parallel prefill attention (``tp.cp``): this rank's query
    rows of the whole prompt (``TensorParallel.cp_rows``) against the
    K/V of every row, which each rank computes whole (its cache holds
    them all); the rows' outputs gathered over ``"model"``
    (:func:`_cp_project`).  Returns ``(out (B, S, D), (K, V))``."""
    b, s, _ = hn.shape
    rows, n = tp.cp_rows(s, hn.device)
    q_rows = (hn[:, rows], rows[None, :].expand(b, n), positions[:, rows])
    out, kv = _attn_forward(p, hn, positions, cfg, kv_mask, tp, q_rows=q_rows,
                            project=False)
    return _cp_project(p, out, cfg, tp, s), kv


def _cp_project(p, out, cfg: ModelConfig, tp, s: int):
    """``wo`` of the attention's rows ``out`` (B, n, H dv), as the
    residual's whole (B, s, D): under context-parallel prefill each
    rank's rows gathered over ``"model"`` after ``wo`` where ``d_model``
    is no wider than ``H dv`` (the published configs: equal widths, and
    ``wo`` then runs on the rank's rows alone), before it otherwise, so
    that the gather moves the narrower of the two; else ``_wo``."""
    if tp is None or not tp.cp:
        return _wo(p, out, cfg, tp)
    if cfg.d_model <= out.shape[-1]:
        return tp.cp_gather(_wo(p, out, cfg, tp), s)
    return _wo(p, tp.cp_gather(out, s), cfg, tp)


def _attn_seq(p, hn, cfg: ModelConfig, tp):
    """Attention under the sequence layout: ``hn`` this rank's positions
    (B, S/size, D) -> their output.  Heads that split (Megatron-SP): the
    gathered whole sequence through this rank's heads, ``wo``'s partial
    sums reduce-scattered.  Heads that do not (context parallel): the
    queries of the rank's positions against the keys and values of the
    gathered sequence, ``wo`` on the rank's positions."""
    b, n, _ = hn.shape
    whole = torch.arange(n * tp.size, device=hn.device)[None, :]
    xg = tp.seq_gather(hn)
    if tp.attn:
        return tp.seq_scatter(_attn_forward(p, xg, whole, cfg, None)[0])
    p0, _ = tp.positions(n * tp.size)
    mine = whole[:, p0:p0 + n].expand(b, n)
    return _attn_forward(p, xg, whole, cfg, None, q_rows=(hn, mine, mine))[0]


def _wo(p, out, cfg: ModelConfig, tp):
    """The attention's output projection; under ``tp`` this rank's heads'
    rows, then the all-reduce."""
    return _row_parallel(L.dense(p["wo"], out, cfg), tp, "attn")


def _block_forward(lp, x, positions, cfg: ModelConfig, kv_mask, tp=None):
    attend = _attn_cp if tp is not None and tp.cp else _attn_forward
    a, kv = attend(lp["attn"], L.rms_norm(lp["ln1"], x, cfg), positions, cfg, kv_mask, tp)
    return _block_mlp(lp, x + a, cfg, tp), kv


# ---------------------------------------------------------------------------
# Training loss and full-sequence logits
# ---------------------------------------------------------------------------

def _train_block(lp, x, positions, cfg: ModelConfig, tp=None):
    if tp is not None and tp.seq:
        x = x + _attn_seq(lp["attn"], L.rms_norm(lp["ln1"], x, cfg), cfg, tp)
        return _block_mlp(lp, x, cfg, tp)
    return _block_forward(lp, x, positions, cfg, None, tp)[0]


def _run_layers(params, x, positions, cfg: ModelConfig, tp=None):
    """Every layer over the whole (causal) sequence, each one
    rematerialised in the backward pass under ``cfg.remat == "layer"``
    (a layer's forward collectives replay in its recompute, in the same
    order on every rank)."""
    for lp in params["layers"]:
        x = L.remat_layer(_train_block, cfg, lp, x, positions, cfg, tp)
    return x


def _final_hidden(params, tokens, cfg: ModelConfig, visual=None, tp=None):
    tokens = tokens.to(torch.int64)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = _run_layers(params, _embed(params, tokens, cfg, visual, tp), positions, cfg, tp)
    return L.rms_norm(params["final_norm"], x, cfg)


def loss_labels(batch, cfg: ModelConfig):
    """``(labels, mask)`` of a batch's next-token loss: the batch's
    ``"mask"`` applied, the visual prefix's positions off."""
    labels, label_mask = L.next_token_labels(batch["tokens"])
    if batch.get("mask") is not None:
        label_mask = label_mask * batch["mask"]
    if cfg.n_visual_tokens:
        label_mask[:, :cfg.n_visual_tokens] = 0.0
    return labels, label_mask


def train_loss(params, batch, cfg: ModelConfig, *, tp=None, denom=None):
    """batch: ``{"tokens": (B, S) int, "mask": optional (B, S) f32,
    "visual": optional (B, nv, D)}``.  Next-token cross entropy, the
    vocabulary projection chunked over the sequence
    (``layers.chunked_xent``, which ``denom`` and ``tp`` reach); the
    visual prefix's positions carry no loss.  Under ``tp`` the
    parameters are this rank's shard and ``cfg`` the rank-local config
    (``sharding.local_config``); under its sequence layout ``"model"``
    must divide S (``TensorParallel.positions`` raises otherwise)."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    assert s % min(cfg.loss_chunk, s) == 0
    x = _final_hidden(params, tokens, cfg, batch.get("visual"), tp)
    labels, label_mask = loss_labels(batch, cfg)
    w = _unembed_weight(params, cfg).to(x.dtype)
    return L.chunked_xent(x, w, labels, label_mask, cfg.loss_chunk, denom=denom, tp=tp)


def logits_fn(params, tokens, cfg: ModelConfig, visual=None):
    """Full-sequence logits (B, S, V) f32 (small models and tests)."""
    x = _final_hidden(params, tokens, cfg, visual)
    return (x @ _unembed_weight(params, cfg).to(x.dtype)).to(torch.float32)


# ---------------------------------------------------------------------------
# Paged cache: block arena + per-row block tables (row-local addressing)
# ---------------------------------------------------------------------------

def _cache_dtype(cfg: ModelConfig):
    if cfg.kv_posit:
        return L.pcfg(cfg.kv_posit).storage_dtype
    return L.cdtype(cfg)


def _maybe_quant_kv(x, cfg: ModelConfig):
    """KV storage form: posit patterns through the CUDA codec, or the
    compute dtype.  The whole-prompt prefill quantizes each layer's KV
    through it; decode and chunked-prefill writes go through the fused
    write of :func:`_write_kv` instead."""
    if cfg.kv_posit:
        return posit_codec.quantize(x.to(torch.float32).contiguous(),
                                    L.pcfg(cfg.kv_posit))
    return x.to(L.cdtype(cfg))


def _write_kv(jobs, slots, cfg: ModelConfig, dense: bool = False):
    """Store KV rows into their arena slots, in place.  ``jobs`` is a
    list of ``(arena leaf of one layer, (R, *feat) rows)``; ``slots``
    the rows' dense flat slots (``layers.paged_write_slots`` or
    ``layers.paged_pack_slots``, -1 drops; ``dense``: every slot in
    range, the linear writes' ``layers.linear_write_slots`` behind a
    capacity check).  Posit KV: one fused quantize-and-write launch,
    drops skipped on the device; otherwise the compute-dtype cast and
    the scatter, masked unless ``dense`` (no host sync then)."""
    if cfg.kv_posit:
        posit_codec.paged_write([(a, x.contiguous()) for a, x in jobs], slots,
                                L.pcfg(cfg.kv_posit))
    else:
        posit_codec.scatter_slots([(a, _maybe_quant_kv(x, cfg)) for a, x in jobs],
                                  slots, dense)


def paged_table_width(cfg: ModelConfig, block_size: int,
                      max_len: int) -> int:
    """Block-table width W: the window ring's ``ceil(window/bs)+1`` when
    a sliding window is active and narrower than the dense
    ``ceil(max_len/bs)``; the dense width otherwise."""
    dense = -(-int(max_len) // int(block_size))
    if cfg.sliding_window and not cfg.mla:
        ring = L.paged_window_blocks(cfg.sliding_window, block_size)
        if ring < dense:
            return ring
    return dense


def _paged_window(cfg: ModelConfig) -> int:
    return 0 if cfg.mla else (cfg.sliding_window or 0)


def arena_keys(cfg: ModelConfig) -> tuple:
    """The lane's two arena leaves: the MLA latent ``c_kv`` and its
    decoupled-RoPE key ``k_rope``, or K and V."""
    return ("c_kv", "k_rope") if cfg.mla else ("k", "v")


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     block_size: int, n_blocks: int, *, device="cuda"):
    """Empty paged pool cache: zeroed arenas, sentinel block tables,
    ``lens`` all zero; ``max_len`` is a Python int."""
    dev = resolve_device(device)
    w = paged_table_width(cfg, block_size, max_len)
    lead = (cfg.n_layers, n_blocks, block_size)
    if cfg.mla:
        shapes = (lead + (cfg.kv_lora_rank,), lead + (cfg.qk_rope_dim,))
    else:
        shapes = (lead + (cfg.n_kv_heads, cfg.head_dim),) * 2
    dt = _cache_dtype(cfg)
    arenas = {key: PT.zeros(shape, dt, dev)
              for key, shape in zip(arena_keys(cfg), shapes)}
    return {
        **arenas,
        "block_tables": torch.full((batch, w), n_blocks, dtype=torch.int32,
                                   device=dev),
        "lens": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "max_len": int(max_len),
    }


# ---------------------------------------------------------------------------
# Linear cache: (L, B, T, ...) leaves with one shared write frontier
#
#   * the time axis is preallocated to ``max_len`` (or to the sliding
#     window, run as a ring written at ``pos % window``);
#   * ``len``: the shared write frontier (padded coordinates), a Python
#     int; ``lens`` (B,) int32 per-row valid counts (``len - lens[b]`` is
#     row b's padding offset); ``max_len`` a Python int.
# ---------------------------------------------------------------------------

def _cache_meta(batch: int, frontier: int, max_len: int, lens=None, *,
                device="cuda"):
    dev = resolve_device(device)
    if lens is None:
        lens = torch.full((batch,), int(frontier), dtype=torch.int32, device=dev)
    return {"len": int(frontier),
            "lens": torch.as_tensor(lens, device=dev).to(torch.int32),
            "max_len": int(max_len)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               window_ring: bool = True, *, device="cuda"):
    """Empty linear decode cache.  ``window_ring=False`` keeps a
    full-``max_len`` cache under a sliding window (the layout the ring
    is tested against)."""
    dev = resolve_device(device)
    meta = _cache_meta(batch, 0, max_len, device=dev)
    dt = _cache_dtype(cfg)
    lead = (cfg.n_layers, batch)
    if cfg.mla:
        return {"c_kv": PT.zeros(lead + (max_len, cfg.kv_lora_rank), dt, dev),
                "k_rope": PT.zeros(lead + (max_len, cfg.qk_rope_dim), dt, dev),
                **meta}
    window = cfg.sliding_window or 0
    t = min(max_len, window) if (window and window_ring) else max_len
    shape = lead + (t, cfg.n_kv_heads, cfg.head_dim)
    return {"k": PT.zeros(shape, dt, dev), "v": PT.zeros(shape, dt, dev), **meta}


def _is_ring(cfg: ModelConfig, capacity: int) -> bool:
    """Window-sized caches run as rings; full-length ones stay linear
    (when the capacity is both the window and ``max_len`` the frontier
    never wraps, so the two readings agree)."""
    return bool(cfg.sliding_window) and capacity == cfg.sliding_window


def _ring_pack(kv, w: int):
    """Fold prompt KV (L, B, S, ...) with S > w into ring layout: slot i
    holds the latest position q <= S-1 with q % w == i (a gather of the
    latest positions, never a scatter with colliding destinations)."""
    s = kv.shape[2]
    idx = (s - 1) - torch.fmod((s - 1) - torch.arange(w, device=kv.device), w)
    return PT.signed_view(kv).index_select(2, idx).view(kv.dtype)


def prefill(params, tokens, cfg: ModelConfig, visual=None, *, max_len=None,
            prompt_lens=None, window_ring: bool = True, block_size: int = 0,
            n_blocks: int = 0, block_tables=None, tp=None):
    """Run whole prompts, return ``(cache, logits (B, V) f32)`` at the
    last position.

    ``tokens`` (B, S) int64 on the device.  ``max_len`` preallocates
    decode headroom (default: a prompt-sized cache, so decode refuses to
    write past it).  ``prompt_lens`` (B,) makes a ragged batch: tokens
    are LEFT-padded, row b's real tokens take the last ``prompt_lens[b]``
    slots with RoPE positions ``0 .. len-1``, and its pad keys are
    masked.  Each layer's KV is quantized once (``_maybe_quant_kv``:
    the codec's quantize on posit KV), then padded or ring-packed into a
    linear cache, or -- with ``block_tables`` (B, W) -- packed into the
    arena blocks the tables name (``block_size``/``n_blocks`` size the
    arena; sentinel entries drop).  The KV values are the same in both
    layouts.  ``visual`` (B, nv, D) replaces the front of the embedded
    sequence on a config with visual tokens (``_embed``).  ``tp``: this
    rank's tensor-parallel plan, ``cfg`` then the rank-local config."""
    b, s = tokens.shape
    dev = tokens.device
    ml = s if max_len is None else int(max_len)
    if ml < s:
        raise ValueError(f"prefill max_len={ml} < prompt length {s}")
    ar = torch.arange(s, device=dev)[None, :]
    if prompt_lens is None:
        lens = torch.full((b,), s, dtype=torch.int32, device=dev)
        positions = ar.expand(b, s)
        kv_mask = torch.ones((b, s), dtype=torch.bool, device=dev)
    else:
        lens = torch.as_tensor(prompt_lens, device=dev).to(torch.int32)
        positions = ar - (s - lens.to(torch.int64))[:, None]
        kv_mask = positions >= 0
    keys = arena_keys(cfg)

    if block_tables is not None:
        tables = torch.as_tensor(block_tables, device=dev).to(torch.int32)
        cache = dict(init_paged_cache(cfg, b, ml, int(block_size), int(n_blocks),
                                      device=dev), block_tables=tables, lens=lens)
        shift = (s - lens) if prompt_lens is not None else None

        def store(li, kv):
            for key, t in zip(keys, kv):
                L.paged_pack(cache[key][li:li + 1], t[None], tables, lens,
                             window=_paged_window(cfg), src_shift=shift)
    else:
        cache = dict(init_cache(cfg, b, ml, window_ring, device=dev), len=s, lens=lens)
        cap = cache[keys[0]].shape[2]

        def store(li, kv):
            for key, t in zip(keys, kv):
                if s > cap:
                    t = _ring_pack(t[None], cap)[0]
                PT.signed_view(cache[key][li])[:, :t.shape[1]] = PT.signed_view(t)

    x = _embed(params, tokens, cfg, visual, tp)
    for li, lp in enumerate(params["layers"]):
        x, kv = _block_forward(lp, x, positions, cfg, kv_mask, tp)
        store(li, tuple(_maybe_quant_kv(t, cfg) for t in kv))
    x = L.rms_norm(params["final_norm"], x, cfg)
    return cache, _logits(params, x[:, -1, :], cfg, tp)


def _chunk_virtual_tables(tables, lens, bs: int, window: int,
                          virtual_width: int, n_blocks: int):
    """Position-ordered virtual block tables for the chunked-prefill
    gather, and the first position the gather covers.

    Dense tables are already position-ordered (sentinel-padded to the
    virtual width).  On the window ring only logical blocks
    ``lb_max-W+1 .. lb_max`` (``lb_max = (lens-1)//bs``) hold their
    latest content; they map through the ring, the rest is the
    sentinel."""
    b, w = tables.shape
    vw = int(virtual_width)
    if L.paged_is_window_lane(window, bs, w):
        lens = lens.to(torch.int64)
        lb_max = torch.div(lens - 1, bs, rounding_mode="floor")
        lb_min = (lb_max - w + 1).clamp(min=0)
        vb = torch.arange(vw, device=tables.device)[None, :]
        slot = torch.fmod(vb, w).expand(b, vw)
        phys = tables.to(torch.int64).gather(1, slot)
        resident = (vb >= lb_min[:, None]) & (vb <= lb_max[:, None])
        vtables = torch.where(resident, phys, n_blocks).to(torch.int32)
        return vtables, lb_min * bs
    if vw < w:
        raise ValueError(
            f"chunked prefill virtual width {vw} < table width {w}")
    if vw > w:
        tables = torch.cat(
            [tables, torch.full((b, vw - w), n_blocks, dtype=tables.dtype,
                                device=tables.device)], dim=1)
    return tables, torch.zeros((b,), dtype=torch.int64, device=tables.device)


def prefill_chunk(params, cache, tokens, cfg: ModelConfig, n_valid, *,
                  virtual_width: int, write_tables=None, tp=None):
    """Append ``C`` prompt tokens per row to the paged cache.

    ``tokens`` (B, C): row b's next prompt tokens for positions
    ``lens[b] ..``, of which the first ``n_valid[b]`` are real; rows with
    ``n_valid == 0`` are no-ops.  ``virtual_width`` is
    ``ceil(max_len / block_size)``, the position-ordered virtual cache
    every lane gathers.  ``write_tables`` (B, W), when given, replaces
    the block tables for the arena write only: the prefix-sharing
    scheduler passes a copy with borrowed entries set to the sentinel,
    so a shared block never takes a write.  Returns ``(cache, logits
    (B, V) f32)`` with the logits at each row's last valid chunk
    position; the arenas are updated in place.

    Fresh chunk KV (MLA: latents) is inserted into the gathered virtual
    buffer before attention (read pre-codec, as a whole-prompt prefill
    reads it) and KV blocks keep the fixed ``attn_chunk_kv`` grouping,
    so every split of a prompt reduces in the same groups.  ``tp``: this
    rank's tensor-parallel plan, ``cfg`` then the rank-local config;
    under context-parallel prefill (``tp.cp``) each rank's queries are
    its share of the chunk's rows (``TensorParallel.cp_rows``), against
    the whole virtual buffer, and every rank still computes, inserts and
    writes the whole chunk's K/V.
    """
    b, c = tokens.shape
    dev = tokens.device
    tables = cache["block_tables"]
    keys = arena_keys(cfg)
    nb, bs = cache[keys[0]].shape[1], cache[keys[0]].shape[2]
    window = _paged_window(cfg)
    lens = cache["lens"].to(torch.int64)
    n_valid = torch.as_tensor(n_valid, device=dev).to(torch.int64)
    lens_after = lens + n_valid
    hi = int(lens_after.max()) if b else 0
    if hi > int(cache["max_len"]):
        raise ValueError(f"prefill_chunk: row frontier {hi} would exceed "
                         f"max_len {int(cache['max_len'])}")

    positions = lens[:, None] + torch.arange(c, device=dev)[None, :]
    vtables, low_pos = _chunk_virtual_tables(
        tables, lens, bs, window, virtual_width, nb)
    t_len = int(virtual_width) * bs
    apos = torch.arange(t_len, device=dev)[None, :]
    kv_mask = (apos < lens_after[:, None]) & (apos >= low_pos[:, None])
    bidx = torch.arange(b, device=dev)[:, None]
    rows = tp.cp_rows(c, dev)[0] if tp is not None and tp.cp else slice(None)
    q_at = positions[:, rows]                     # the queries' positions

    def load(li):
        # both leaves of layer li, (B, T, ...) each, zero where not
        # resident: posit arenas in one fused launch, f32/bf16 arenas
        # through the plain gather, cast and mask
        arenas = [cache[key][li] for key in keys]
        if cfg.kv_posit:
            return posit_codec.paged_read(arenas, vtables, lens, low_pos,
                                          L.pcfg(cfg.kv_posit), L.cdtype(cfg))
        return posit_codec.paged_read_plain(arenas, vtables, lens, low_pos,
                                            None, L.cdtype(cfg))

    def insert(ctx, fresh):
        # row b's fresh chunk lands at virtual slots lens[b]+j; slots past
        # the buffer fall into C spare slots that are then cut off
        ext = torch.cat([ctx, ctx.new_zeros((b, c) + tuple(ctx.shape[2:]))], 1)
        ext[bidx, positions] = fresh.to(ext.dtype)
        return ext[:, :t_len]

    def attend_mla(at, hn, li):
        h, nope, rope = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
        nq = q_at.shape[1]
        q_lat = L.rms_norm(at["q_norm"], L.dense(at["wdq"], hn[:, rows], cfg), cfg)
        q = L.dense(at["wuq"], q_lat, cfg).reshape(b, nq, h, nope + rope)
        q_nope, q_rope = q.split([nope, rope], dim=-1)
        q = torch.cat([q_nope, L.apply_rope(q_rope, q_at,
                                            cfg.rope_theta)], -1)
        c_suf, r_suf = L.dense(at["wdkv"], hn, cfg).split(
            [cfg.kv_lora_rank, rope], dim=-1)
        c_suf = L.rms_norm(at["kv_norm"], c_suf, cfg)
        r_suf = L.apply_rope(r_suf[:, :, None, :], positions,
                             cfg.rope_theta)[:, :, 0, :]
        c_ctx, r_ctx = load(li)
        c_all = insert(c_ctx, c_suf)                         # (B, T, rank)
        r_all = insert(r_ctx, r_suf)
        k_nope = L.dense(at["wuk"], c_all, cfg).reshape(b, t_len, h, nope)
        v = L.dense(at["wuv"], c_all, cfg).reshape(b, t_len, h,
                                                   cfg.v_head_dim)
        k = torch.cat([k_nope, r_all[:, :, None, :].expand(
            b, t_len, h, rope)], -1)
        out = L.flash_attention(q, k, v, causal=True, cfg=cfg, kv_mask=kv_mask,
                                q_positions=q_at)
        return out.reshape(b, nq, h * cfg.v_head_dim), (c_suf, r_suf)

    def attend_dense(at, hn, li):
        nq = q_at.shape[1]
        q = L.dense(at["wq"], hn[:, rows], cfg).reshape(b, nq, cfg.n_heads, cfg.head_dim)
        k_suf = L.dense(at["wk"], hn, cfg).reshape(b, c, cfg.n_kv_heads,
                                                   cfg.head_dim)
        v_suf = L.dense(at["wv"], hn, cfg).reshape(b, c, cfg.n_kv_heads,
                                                   cfg.head_dim)
        q = L.apply_rope(q, q_at, cfg.rope_theta)
        k_suf = L.apply_rope(k_suf, positions, cfg.rope_theta)
        k_ctx, v_ctx = load(li)
        k = insert(k_ctx, k_suf)
        v = insert(v_ctx, v_suf)
        out = L.flash_attention(q, k, v, causal=True, cfg=cfg, kv_mask=kv_mask,
                                q_positions=q_at, window=cfg.sliding_window)
        return out.reshape(b, nq, cfg.n_heads * cfg.head_dim), (k_suf, v_suf)

    attend = attend_mla if cfg.mla else attend_dense
    x = _embed(params, tokens, cfg, tp=tp)
    fresh = ([], [])                        # each layer's chunk K/V
    for li, lp in enumerate(params["layers"]):
        out, new = attend(lp["attn"], L.rms_norm(lp["ln1"], x, cfg), li)
        x = x + _cp_project(lp["attn"], out, cfg, tp, c)
        x = _block_mlp(lp, x, cfg, tp)
        for acc, t in zip(fresh, new):
            acc.append(t)

    wt = tables if write_tables is None else torch.as_tensor(
        write_tables, dtype=torch.int32, device=dev)
    # one write per leaf covers all layers
    slots = L.paged_pack_slots(wt, lens, lens_after, c, n_blocks=nb,
                               block_size=bs, window=window).reshape(-1)
    for key, kv in zip(keys, fresh):
        _write_kv([(cache[key][li], t.reshape((b * c,) + t.shape[2:]))
                   for li, t in enumerate(kv)], slots, cfg)
    new_cache = dict(cache, lens=lens_after.to(torch.int32))

    x = L.rms_norm(params["final_norm"], x, cfg)
    last_idx = (n_valid - 1).clamp(0, c - 1)
    last = x[torch.arange(b, device=dev), last_idx]          # (B, D)
    return new_cache, _logits(params, last, cfg, tp)


def _decode_attn_dense_paged(p, x, k_arena, v_arena, tables, lens, slots,
                             cfg: ModelConfig, tp=None):
    """One layer of paged dense/GQA decode: write the row's new K/V at
    ``lens[b]`` (``slots`` from ``layers.paged_write_slots``), then attend
    straight off the block tables."""
    b = x.shape[0]
    window = _paged_window(cfg)
    q = L.dense(p["wq"], x, cfg).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    k = L.dense(p["wk"], x, cfg).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
    v = L.dense(p["wv"], x, cfg).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
    q = L.apply_rope(q, lens[:, None], cfg.rope_theta)
    k = L.apply_rope(k, lens[:, None], cfg.rope_theta)

    _write_kv([(k_arena, k[:, 0]), (v_arena, v[:, 0])], slots, cfg)
    out = L.decode_attention_paged(
        q, k_arena, v_arena, tables, lens, cfg=cfg, kv_posit=cfg.kv_posit,
        window=window, kernel=cfg.paged_attn_kernel)
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return _wo(p, out, cfg, tp)


def _decode_attn_mla_paged(p, x, c_arena, r_arena, tables, lens, slots,
                           cfg: ModelConfig, tp=None):
    """One layer of paged absorbed-matrix MLA decode: write the row's new
    latent and RoPE key at ``lens[b]``, absorb ``q_nope`` through ``wuk``
    into latent space, attend off the block tables, then apply ``wuv``.
    Both absorptions run in f32, as the reference's do."""
    b = x.shape[0]
    h, nope, rope = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    rank = cfg.kv_lora_rank
    q_lat = L.rms_norm(p["q_norm"], L.dense(p["wdq"], x, cfg), cfg)
    q = L.dense(p["wuq"], q_lat, cfg).reshape(b, h, nope + rope)
    q_nope, q_rope = q.split([nope, rope], dim=-1)
    q_rope = L.apply_rope(q_rope[:, None], lens[:, None], cfg.rope_theta)[:, 0]

    c_new, r_new = L.dense(p["wdkv"], x, cfg).split([rank, rope], dim=-1)
    c_new = L.rms_norm(p["kv_norm"], c_new, cfg)
    r_new = L.apply_rope(r_new[:, :, None, :], lens[:, None],
                         cfg.rope_theta)[:, :, 0, :]
    _write_kv([(c_arena, c_new[:, 0]), (r_arena, r_new[:, 0])], slots, cfg)

    wuk = L.maybe_dequant(p["wuk"]["w"], cfg).to(torch.float32).reshape(
        rank, h, nope)
    q_lat_eff = torch.einsum("bhd,rhd->bhr", q_nope.to(torch.float32), wuk)
    ctx = L.decode_attention_paged_mla(
        q_lat_eff, q_rope, c_arena, r_arena, tables, lens, cfg=cfg,
        kv_posit=cfg.kv_posit, kernel=cfg.paged_attn_kernel)
    wuv = L.maybe_dequant(p["wuv"]["w"], cfg).to(torch.float32).reshape(
        rank, h, cfg.v_head_dim)
    out = torch.einsum("bhr,rhv->bhv", ctx, wuv)
    out = out.reshape(b, 1, h * cfg.v_head_dim).to(x.dtype)
    return _wo(p, out, cfg, tp)


def _decode_step_paged(params, cache, token, cfg: ModelConfig, active, tp=None):
    """Paged decode: every row writes at its own position ``lens[b]``;
    inactive rows' writes are dropped and their ``lens`` frozen, and so
    are writes past ``max_len``.  One set of write slots serves every
    layer and both arena leaves.  ``tp``: this rank's tensor-parallel
    plan, ``cfg`` then the rank-local config (the arena holds this
    rank's heads, so the write and the read stay rank-local)."""
    b = token.shape[0]
    dev = token.device
    lens = cache["lens"].to(torch.int32)
    tables = cache["block_tables"]
    adv = torch.ones((b,), dtype=torch.int32, device=dev) if active is None \
        else torch.as_tensor(active, device=dev).to(torch.int32)
    ok = (adv > 0) & (lens < int(cache["max_len"]))
    k1, k2 = arena_keys(cfg)
    nb, bs = cache[k1].shape[1], cache[k1].shape[2]
    slots = L.paged_write_slots(tables, lens, ok, n_blocks=nb, block_size=bs,
                                window=_paged_window(cfg))
    attend = _decode_attn_mla_paged if cfg.mla else _decode_attn_dense_paged
    x = _embed(params, token[:, None], cfg, tp=tp)
    for li, lp in enumerate(params["layers"]):
        x = x + attend(lp["attn"], L.rms_norm(lp["ln1"], x, cfg),
                       cache[k1][li], cache[k2][li], tables, lens, slots, cfg, tp)
        x = _block_mlp(lp, x, cfg, tp)
    new_cache = dict(cache, lens=lens + adv)
    x = L.rms_norm(params["final_norm"], x, cfg)
    return _logits(params, x[:, 0, :], cfg, tp), new_cache


def _decode_attn_dense(p, x, k_cache, v_cache, pos: int, lens, slots,
                       cfg: ModelConfig, tp=None, dense: bool = True):
    """One layer of linear dense/GQA decode: write every row's new K/V
    at the shared frontier ``pos`` (``slots`` from
    ``layers.linear_write_slots``: ``pos % T`` on a ring), then attend
    over the whole dequantized cache, row b from ``pos - lens[b]``."""
    b = x.shape[0]
    ring = _is_ring(cfg, k_cache.shape[1])
    q = L.dense(p["wq"], x, cfg).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    k = L.dense(p["wk"], x, cfg).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
    v = L.dense(p["wv"], x, cfg).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
    q = L.apply_rope(q, lens[:, None], cfg.rope_theta)
    k = L.apply_rope(k, lens[:, None], cfg.rope_theta)
    _write_kv([(k_cache, k[:, 0]), (v_cache, v[:, 0])], slots, cfg, dense)
    out = L.decode_attention(
        q, k_cache, v_cache, pos + 1, cfg=cfg, kv_posit=cfg.kv_posit,
        window=cfg.sliding_window or 0, start=pos - lens, ring=ring)
    return _wo(p, out.reshape(b, 1, cfg.n_heads * cfg.head_dim), cfg, tp)


def _decode_attn_mla(p, x, c_cache, r_cache, pos: int, lens, slots,
                     cfg: ModelConfig, tp=None, dense: bool = True):
    """One layer of linear absorbed-matrix MLA decode: write the new
    latent and RoPE key at ``pos``, dequantize the whole latent cache and
    attend in latent space with a plain softmax (the reference's own
    order of operations, not ``decode_attention``'s)."""
    b = x.shape[0]
    h, nope, rope = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    rank = cfg.kv_lora_rank
    q_lat = L.rms_norm(p["q_norm"], L.dense(p["wdq"], x, cfg), cfg)
    q = L.dense(p["wuq"], q_lat, cfg).reshape(b, h, nope + rope)
    q_nope, q_rope = q.split([nope, rope], dim=-1)
    q_rope = L.apply_rope(q_rope[:, None], lens[:, None], cfg.rope_theta)[:, 0]
    c_new, r_new = L.dense(p["wdkv"], x, cfg).split([rank, rope], dim=-1)
    c_new = L.rms_norm(p["kv_norm"], c_new, cfg)
    r_new = L.apply_rope(r_new[:, :, None, :], lens[:, None],
                         cfg.rope_theta)[:, :, 0, :]
    _write_kv([(c_cache, c_new[:, 0]), (r_cache, r_new[:, 0])], slots, cfg, dense)

    c, r = c_cache, r_cache
    if cfg.kv_posit:                       # both leaves in one launch, f32
        c, r = posit_codec.dequantize_many([c, r], L.pcfg(cfg.kv_posit))
    c, r = c.to(torch.float32), r.to(torch.float32)
    wuk = L.maybe_dequant(p["wuk"]["w"], cfg).to(torch.float32).reshape(rank, h, nope)
    q_lat_eff = torch.einsum("bhd,rhd->bhr", q_nope.to(torch.float32), wuk)
    scores = torch.einsum("bhr,btr->bht", q_lat_eff, c)
    scores = scores + torch.einsum("bhd,btd->bht", q_rope.to(torch.float32), r)
    scale = (nope + rope) ** -0.5
    t_pos = torch.arange(c.shape[1], device=x.device)[None, :]
    valid = (t_pos <= pos) & (t_pos >= (pos - lens.to(torch.int64))[:, None])
    scores = torch.where(valid[:, None, :], scores * scale, L._NEG)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bht,btr->bhr", probs, c)
    wuv = L.maybe_dequant(p["wuv"]["w"], cfg).to(torch.float32).reshape(
        rank, h, cfg.v_head_dim)
    out = torch.einsum("bhr,rhv->bhv", ctx, wuv)
    out = out.reshape(b, 1, h * cfg.v_head_dim).to(x.dtype)
    return _wo(p, out, cfg, tp)


def _decode_lens(cache, pos: int, batch: int, device):
    lens = cache.get("lens")
    if lens is None:                       # a cache without per-row counts
        lens = torch.full((batch,), pos, dtype=torch.int32, device=device)
    return lens.to(torch.int32)


def _decode_step_linear(params, cache, token, cfg: ModelConfig, active, tp=None):
    """Linear decode: every row writes at the shared frontier ``len``,
    which always advances; inactive rows' ``lens`` stay frozen (their
    outputs are discarded).  One set of write slots serves every layer
    and both leaves: one fused write launch a layer on posit KV.  ``tp``:
    this rank's tensor-parallel plan, ``cfg`` then the rank-local config
    (the cache holds this rank's KV heads, or all of them where they do
    not split, and MLA's latents whole)."""
    b = token.shape[0]
    dev = token.device
    pos = int(cache["len"])
    lens = _decode_lens(cache, pos, b, dev)
    adv = torch.ones((b,), dtype=torch.int32, device=dev) if active is None \
        else torch.as_tensor(active, device=dev).to(torch.int32)
    k1, k2 = arena_keys(cfg)
    cap = cache[k1].shape[2]
    ring = not cfg.mla and _is_ring(cfg, cap)
    slots = L.linear_write_slots(b, cap, pos, ring=ring, device=dev)
    dense = ring or pos < cap              # else every slot is -1: the write drops
    attend = _decode_attn_mla if cfg.mla else _decode_attn_dense
    x = _embed(params, token[:, None], cfg, tp=tp)
    for li, lp in enumerate(params["layers"]):
        x = x + attend(lp["attn"], L.rms_norm(lp["ln1"], x, cfg),
                       cache[k1][li], cache[k2][li], pos, lens, slots, cfg, tp, dense)
        x = _block_mlp(lp, x, cfg, tp)
    new_cache = dict(cache, len=pos + 1, lens=lens + adv)
    x = L.rms_norm(params["final_norm"], x, cfg)
    return _logits(params, x[:, 0, :], cfg, tp), new_cache


def decode_step(params, cache, token, cfg: ModelConfig, active=None, tp=None):
    """token (B,) -> (logits (B, V) f32, cache).

    ``active`` (B,) bool marks rows holding a live request; inactive rows
    still produce (discarded) logits and their ``lens`` stays frozen.  A
    paged cache (a ``block_tables`` leaf) writes every row at its own
    ``lens[b]``; a linear cache writes every row at the shared frontier
    ``len``, which always advances.  A write past the capacity raises
    here, before the step (a ring never runs out).  ``tp``: this rank's
    tensor-parallel plan, ``cfg`` then the rank-local config."""
    if "block_tables" not in cache:
        k1 = arena_keys(cfg)[0]
        cap = cache[k1].shape[2]
        if cfg.mla:
            L.check_cache_capacity(cache["len"], cap, "MLA latent cache")
        elif not _is_ring(cfg, cap):
            L.check_cache_capacity(cache["len"], cap)
        return _decode_step_linear(params, cache, token, cfg, active, tp)
    live = torch.ones_like(cache["lens"], dtype=torch.bool) if active is None \
        else torch.as_tensor(active, device=cache["lens"].device).to(torch.bool)
    if bool(live.any()):
        top = int(cache["lens"][live].max())
        L.check_cache_capacity(top, int(cache["max_len"]), "paged KV cache")
    return _decode_step_paged(params, cache, token, cfg, active, tp)
