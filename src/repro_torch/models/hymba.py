"""Hymba: a hybrid-head LM, attention and Mamba2-style SSM heads in
parallel.

The port of ``repro/models/hymba.py``: ``train_loss`` and ``logits_fn``
over whole sequences (the chunk-parallel SSD engine ``ssd_chunked``, the
meta tokens in place of the sequence's front), and the serving entry
points. In every layer the same input feeds GQA attention heads
(sliding-window in most layers, full in ``cfg.global_layers``) and SSM
heads (a scalar data-dependent decay a head, state size N); the two
outputs are RMS-normalized and averaged before the output projection.

The cache (``init_cache``): a ring of ``min(max_len, window)`` slots a
layer (``k_swa``/``v_swa``, written at ``pos % T``), full-length caches
for the global layers only (``k_glb``/``v_glb``), the SSM state ``ssm``
(L, B, H, P, N) f32, the shared frontier ``len`` and ``max_len`` as
Python ints and per-row ``lens``.  Each decode layer writes its K and V
with one fused quantize-and-write launch on posit KV
(``transformer._write_kv`` at ``layers.linear_write_slots``; a global
layer's write past its capacity raises first) and reads both leaves
through ``layers.decode_attention`` (one dequantize launch), the ring
layers with ``ring=True``.  ``prefill`` is a loop of ``decode_step``
over the prompt, as in the reference; the meta tokens are not read on
this path (the reference's serving path does not read them either).
The SSD step runs in plain PyTorch, as the reference's runs in plain
``jnp``.  Cache writes are in place.

Tensor-parallel serving: ``prefill`` and ``decode_step`` take ``tp``
(``runtime/collectives.TensorParallel``) and run on the rank-local config
(``sharding.local_config``) over this rank's shard.  Where the mixer
splits, a rank runs attention head i and SSM head i together (``_merge``
adds their features): its query heads, its KV heads (whole where there
is one), its SSM heads' share of ``in_proj``'s ``xs``, ``gate`` and
``dt`` columns (``B`` and ``C`` whole) and of the whole ``A_log``,
``dt_bias`` and ``D``; ``attn_norm`` and ``ssm_norm`` normalise over
every rank's features (f32 sums all-reduced); ``wo`` is row-parallel.
The ring, the global KV and the SSM state hold this rank's heads.  The
MLP splits on ``d_ff``, the embedding and head on the vocabulary, each
where its size divides.

Tensor-parallel training: ``train_loss`` takes ``tp`` too and runs the
same layers under autograd, the inputs of ``wq``/``wk``/``wv``,
``in_proj`` and the MLP through ``layers.enter``.  ``A_log``,
``dt_bias``, ``D``, ``attn_norm``, ``ssm_norm`` and the ``B`` and ``C``
columns of ``in_proj`` then hold only this rank's heads' part of their
gradient, which the train step all-reduces
(``sharding.partial_grad_leaves``).

The sequence layout (``tp.seq``, the reference's
``_attn_context_parallel``) changes the attention branch alone, and only
where its heads do not split: the queries of this rank's positions
against the keys and values of the whole sequence (the window or global
mask on absolute positions), ``attn_norm`` on those positions, then
``tp.seq_gather_replicated`` back to the whole sequence before the
merge.  The SSM branch, the merge, the MLP and the residual stay whole
on every rank, as in the reference (it sets no residual constraint in
hymba); the branch's input enters through ``tp.enter``, since each
rank's queries give a part of its gradient.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import types as PT
from repro_torch.device import resolve_device
from . import layers as L
from . import transformer as T
from .config import ModelConfig

_F32 = torch.float32


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda", dtype=None,
                shard=None):
    """Random parameters from a seeded ``torch.Generator`` on ``device``:
    weights drawn in f32 and stored in ``dtype`` (default the compute
    dtype; training passes ``torch.float32``), norm scales, ``A_log``,
    ``dt_bias`` and ``D`` f32 (the forward reads them in f32).
    ``shard(subtree, prefix)`` cuts each layer and top-level leaf to this
    rank's shard as it is drawn (``transformer.init_params``)."""
    keep = shard or (lambda t, prefix: t)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    dt = L.cdtype(cfg) if dtype is None else dtype
    d = cfg.d_model
    hs, p_dim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_in = hs * p_dim
    layers = []
    for i in range(cfg.n_layers):
        layers.append(keep({
            "ln1": L.init_rms_norm(d, cfg, dev),
            "ln2": L.init_rms_norm(d, cfg, dev),
            # attention branch
            "wq": L.init_dense(gen, d, cfg.n_heads * cfg.head_dim, dtype=dt),
            "wk": L.init_dense(gen, d, cfg.n_kv_heads * cfg.head_dim, dtype=dt),
            "wv": L.init_dense(gen, d, cfg.n_kv_heads * cfg.head_dim, dtype=dt),
            "attn_norm": L.init_rms_norm(cfg.n_heads * cfg.head_dim, cfg, dev),
            # ssm branch
            "in_proj": L.init_dense(gen, d, 2 * d_in + 2 * n + hs, dtype=dt),
            "A_log": torch.zeros((hs,), dtype=_F32, device=dev),
            "dt_bias": torch.zeros((hs,), dtype=_F32, device=dev),
            "D": torch.ones((hs,), dtype=_F32, device=dev),
            "ssm_norm": L.init_rms_norm(d_in, cfg, dev),
            # merge + mlp
            "wo": L.init_dense(gen, d_in, d, dtype=dt),
            "mlp": L.init_mlp(gen, cfg, dtype=dt),
        }, f"layers/{i}"))

    def normal(shape):
        return (torch.randn(shape, generator=gen, device=dev, dtype=_F32)
                * 0.02).to(dt)

    params = {
        "tok_embed": keep(normal((cfg.vocab, d)), "tok_embed"),
        "layers": layers,
        "final_norm": L.init_rms_norm(d, cfg, dev),
        "lm_head": keep(L.init_dense(gen, d, cfg.vocab, dtype=dt), "lm_head"),
    }
    if cfg.n_meta_tokens:
        params["meta_tokens"] = normal((cfg.n_meta_tokens, d))
    return params


# ---------------------------------------------------------------------------
# SSD step and the hybrid block's pieces
# ---------------------------------------------------------------------------

def ssd_step(x, b_in, c_in, dt, a_log, h):
    """Single decode step.  x: (B,H,P); b_in, c_in: (B,N); dt: (B,H);
    h: (B,H,P,N).  Returns (y (B,H,P), new h)."""
    a = torch.exp((-torch.exp(a_log))[None, :] * dt)          # (B,H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, x, b_in)
    h = a[..., None, None] * h + upd
    y = torch.einsum("bhpn,bn->bhp", h, c_in)
    return y, h


def _heads_of(v, cfg: ModelConfig, tp):
    """This rank's SSM heads of a whole per-head vector (``A_log``,
    ``dt_bias``, ``D``); ``tp`` the plan where the mixer splits."""
    h = cfg.ssm_heads
    return v if tp is None else v.narrow(0, tp.rank * h, h)


def _split_ssm_proj(p, x, cfg: ModelConfig, tp=None):
    hs, p_dim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_in = hs * p_dim
    z = L.dense(p["in_proj"], x, cfg)
    xs, gate, b_in, c_in, dt = torch.split(z, [d_in, d_in, n, n, hs], dim=-1)
    dt = dt.to(_F32) + _heads_of(p["dt_bias"], cfg, tp)[None, None, :]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))            # softplus
    return xs, gate, b_in.to(_F32), c_in.to(_F32), dt


def _merge(p, attn_out, ssm_out, cfg: ModelConfig, tp=None):
    return L.dense_row(p["wo"], 0.5 * (attn_out + ssm_out), cfg, tp)


# ---------------------------------------------------------------------------
# SSD chunk-parallel engine and the whole-sequence forward (training)
# ---------------------------------------------------------------------------

def ssd_chunked(x, b_in, c_in, dt, a_log, h0, chunk: int):
    """Chunk-parallel SSD with a scalar log decay a head (every exponent
    <= 0; (C, C) ratio matrices, no channel axis).  x: (B,S,H,P);
    b_in, c_in: (B,S,N); dt: (B,S,H) (after the softplus); h0:
    (B,H,P,N).  Returns (y (B,S,H,P), the final state)."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    la = (-torch.exp(a_log))[None, None, :] * dt              # log decay <= 0
    xs = x.reshape(bsz, nc, chunk, h, p).permute(1, 0, 3, 2, 4)
    bs = b_in.reshape(bsz, nc, chunk, n).permute(1, 0, 2, 3)
    cs = c_in.reshape(bsz, nc, chunk, n).permute(1, 0, 2, 3)
    dts = dt.reshape(bsz, nc, chunk, h).permute(1, 0, 3, 2)
    las = la.reshape(bsz, nc, chunk, h).permute(1, 0, 3, 2)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    hprev, ys = h0, []
    for ci in range(nc):
        xx, bb, cc, dd, ll = xs[ci], bs[ci], cs[ci], dts[ci], las[ci]
        li = torch.cumsum(ll, dim=-1)                          # (B,H,C) inclusive
        diff = li[:, :, :, None] - li[:, :, None, :]           # (B,H,C,C)
        ratio = torch.where(tri[None, None], torch.exp(torch.clamp(diff, max=0.0)),
                            0.0)
        sc = torch.einsum("bcn,bjn->bcj", cc, bb)               # (B,C,C)
        scores = sc[:, None] * ratio * dd[:, :, None, :]        # (B,H,C,C)
        y = torch.einsum("bhcj,bhjp->bhcp", scores, xx)
        # inter-chunk: y += exp(li) * C . h_prev
        y = y + torch.einsum("bcn,bhpn->bhcp", cc, hprev) * torch.exp(li)[..., None]
        # state update
        l_tot = li[:, :, -1:]
        wsc = torch.exp(l_tot - li) * dd                        # (B,H,C)
        upd = torch.einsum("bhc,bhcp,bcn->bhpn", wsc, xx, bb)
        hprev = torch.exp(l_tot[:, :, 0])[..., None, None] * hprev + upd
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(bsz, s, h, p)
    return y, hprev


def _ssm_branch_full(p, x, cfg: ModelConfig, h0=None, tp=None):
    """``tp``: the plan where the mixer splits; ``in_proj``'s input
    enters its column-parallel product (``B`` and ``C`` are whole on
    every rank but feed only this rank's heads)."""
    bsz, s, _ = x.shape
    hs, p_dim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xs, gate, b_in, c_in, dt = _split_ssm_proj(p, L.enter(x, tp), cfg, tp)
    xh = xs.reshape(bsz, s, hs, p_dim).to(_F32)
    if h0 is None:
        h0 = torch.zeros((bsz, hs, p_dim, n), dtype=_F32, device=x.device)
    y, hfin = ssd_chunked(xh, b_in, c_in, dt, _heads_of(p["A_log"], cfg, tp), h0,
                          min(cfg.wkv_chunk, s))
    y = y + _heads_of(p["D"], cfg, tp)[None, None, :, None] * xh
    y = y.reshape(bsz, s, hs * p_dim).to(x.dtype) * F.silu(gate)
    return L.rms_norm(p["ssm_norm"], y, cfg, tp), hfin


def _attn_branch_full(p, x, positions, cfg: ModelConfig, *, is_global, tp=None, cp=None):
    """``tp``: the plan where the mixer splits; the input enters ``wq``
    (and ``wk``/``wv`` where the KV heads split; one whole KV head's K
    and V enter instead, as every rank's heads read them).  ``cp``: the
    plan of a context-parallel branch (the sequence layout, the heads
    whole): the queries of this rank's positions against every key, the
    normalised output gathered back to the whole sequence."""
    bsz, s, _ = x.shape
    hd = cfg.head_dim
    q_pos = positions.expand(bsz, s)
    if cp is not None:
        x = cp.enter(x)
        p0, sq = cp.positions(s)
        xq, q_pos = cp.seq_slice(x), q_pos[:, p0:p0 + sq]
    else:
        xq, sq = L.enter(x, tp), s
    xkv = xq if tp is not None and tp.kv else x
    q = L.dense(p["wq"], xq, cfg).reshape(bsz, sq, cfg.n_heads, hd)
    k = L.dense(p["wk"], xkv, cfg).reshape(bsz, s, cfg.n_kv_heads, hd)
    v = L.dense(p["wv"], xkv, cfg).reshape(bsz, s, cfg.n_kv_heads, hd)
    if tp is not None and not tp.kv:
        k, v = tp.enter(k), tp.enter(v)
    q = L.apply_rope(q, q_pos, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    window = 0 if is_global else cfg.sliding_window
    out = L.flash_attention(q, k, v, causal=True, cfg=cfg, window=window, q_positions=q_pos)
    out = L.rms_norm(p["attn_norm"], out.reshape(bsz, sq, cfg.n_heads * hd), cfg, tp)
    return (out if cp is None else cp.seq_gather_replicated(out)), (k, v)


def _train_layer(lp, h, positions, cfg: ModelConfig, is_global: bool, tp=None):
    mix, ff = L.split_plan(tp, "attn"), L.split_plan(tp, "mlp")
    cp = tp if tp is not None and tp.seq and mix is None else None
    xin = L.rms_norm(lp["ln1"], h, cfg)
    a, _ = _attn_branch_full(lp, xin, positions, cfg, is_global=is_global, tp=mix, cp=cp)
    m, _ = _ssm_branch_full(lp, xin, cfg, tp=mix)
    h = h + _merge(lp, a, m, cfg, mix)
    return h + L.mlp(lp["mlp"], L.enter(L.rms_norm(lp["ln2"], h, cfg), ff), cfg, ff)


def _forward(params, tokens, cfg: ModelConfig, tp=None):
    """The whole sequence, the meta tokens in place of its first
    ``n_meta_tokens`` embeddings (the length stays S); global layers
    attend over everything, the others over ``sliding_window``.  Window
    layers are rematerialised in the backward pass under ``cfg.remat ==
    "layer"`` (the reference scans them under ``jax.checkpoint``) and
    global layers are not.  Returns the final norm's output.  ``tp``:
    this rank's plan, ``cfg`` then the rank-local config."""
    bsz, s0 = tokens.shape
    table, tokens = params["tok_embed"], tokens.to(torch.int64)
    x = (table[tokens] if tp is None else tp.embed(table, tokens)).to(L.cdtype(cfg))
    if cfg.n_meta_tokens:
        meta = params["meta_tokens"][None].to(x.dtype).expand(
            bsz, cfg.n_meta_tokens, cfg.d_model)
        x = torch.cat([meta, x[:, :s0 - cfg.n_meta_tokens]], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    glb = set(cfg.global_layers)
    for li, lp in enumerate(params["layers"]):
        if li in glb:
            x = _train_layer(L.gathered(lp), x, positions, cfg, True, tp)
        else:
            x = L.remat_layer(_train_layer, cfg, lp, x, positions, cfg, False, tp)
    return L.rms_norm(params["final_norm"], x, cfg)


def loss_labels(batch, cfg: ModelConfig):
    """``(labels, mask)`` of the next-token loss: the meta tokens'
    positions off; a ``"mask"`` is ignored, as in the reference."""
    labels, mask = L.next_token_labels(batch["tokens"])
    if cfg.n_meta_tokens:
        mask[:, :cfg.n_meta_tokens] = 0.0
    return labels, mask


def train_loss(params, batch, cfg: ModelConfig, *, tp=None, denom=None):
    """Next-token cross entropy over :func:`loss_labels`; ``denom``
    divides the sum instead of the batch's own label count.  Under
    ``tp`` the parameters are this rank's shard, ``cfg`` the rank-local
    config and the loss vocabulary-parallel where the vocabulary
    splits."""
    x = _forward(params, batch["tokens"], cfg, tp)
    labels, mask = loss_labels(batch, cfg)
    w = params["lm_head"]["w"].to(x.dtype)
    if tp is not None and tp.seq:           # the residual, and so the head's input, is whole
        tp = dataclasses.replace(tp, seq=False)
    return L.chunked_xent(x, w, labels, mask, cfg.loss_chunk, denom=denom, tp=tp)


def logits_fn(params, tokens, cfg: ModelConfig, visual=None):
    """Full-sequence logits (B, S, V) f32."""
    del visual
    x = _forward(params, tokens, cfg)
    return (x @ params["lm_head"]["w"].to(x.dtype)).to(_F32)


# ---------------------------------------------------------------------------
# serving: ring SWA caches + tiny SSM state (+ full cache on global layers)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    """Empty cache: a ring of ``min(max_len, window)`` slots for every
    layer, full-length caches for the global layers, zero SSM state."""
    dev = resolve_device(device)
    hs, p_dim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    t_swa = min(max_len, cfg.sliding_window or max_len)
    kv = (batch, t_swa, cfg.n_kv_heads, cfg.head_dim)
    kv_g = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = T._cache_dtype(cfg)
    n_glb = len(cfg.global_layers)
    return {
        "k_swa": PT.zeros((cfg.n_layers,) + kv, dt, dev),
        "v_swa": PT.zeros((cfg.n_layers,) + kv, dt, dev),
        "k_glb": PT.zeros((n_glb,) + kv_g, dt, dev),
        "v_glb": PT.zeros((n_glb,) + kv_g, dt, dev),
        "ssm": torch.zeros((cfg.n_layers, batch, hs, p_dim, n), dtype=_F32,
                           device=dev),
        "len": 0,
        "lens": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "max_len": int(max_len),
    }


def decode_step(params, cache, token, cfg: ModelConfig, active=None, tp=None):
    """token (B,) -> (logits (B, V) f32, cache).  Every row writes at the
    shared frontier ``len``; ``active`` (B,) bool freezes inactive rows'
    ``lens``.  A global layer's write past its capacity raises here.
    ``tp``: this rank's tensor-parallel plan, ``cfg`` then the rank-local
    config."""
    pos = int(cache["len"])
    b = token.shape[0]
    dev = token.device
    if cfg.global_layers:
        L.check_cache_capacity(pos, cache["k_glb"].shape[2],
                               "global-layer KV cache")
    glb_index = {i: j for j, i in enumerate(cfg.global_layers)}
    ring_slots = L.linear_write_slots(b, cache["k_swa"].shape[2], pos, ring=True,
                                      device=dev)
    glb_slots = L.linear_write_slots(b, cache["k_glb"].shape[2], pos, ring=False,
                                     device=dev)
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=dev)
    hd, g = cfg.head_dim, cfg.n_kv_heads
    mix, ff = L.split_plan(tp, "attn"), L.split_plan(tp, "mlp")
    table = params["tok_embed"]
    h = (table[token] if tp is None else tp.embed(table, token))[:, None, :].to(L.cdtype(cfg))
    for li, lp in enumerate(params["layers"]):
        xin = L.rms_norm(lp["ln1"], h, cfg)
        q = L.dense(lp["wq"], xin, cfg).reshape(b, 1, cfg.n_heads, hd)
        k = L.dense(lp["wk"], xin, cfg).reshape(b, 1, g, hd)
        v = L.dense(lp["wv"], xin, cfg).reshape(b, 1, g, hd)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        if li in glb_index:
            kc, vc = cache["k_glb"][glb_index[li]], cache["v_glb"][glb_index[li]]
            T._write_kv([(kc, k[:, 0]), (vc, v[:, 0])], glb_slots, cfg, dense=True)
            att = L.decode_attention(q, kc, vc, pos + 1, cfg=cfg,
                                     kv_posit=cfg.kv_posit)
        else:
            # ring buffer: written at pos % T, rotation-aware masking
            kc, vc = cache["k_swa"][li], cache["v_swa"][li]
            T._write_kv([(kc, k[:, 0]), (vc, v[:, 0])], ring_slots, cfg, dense=True)
            att = L.decode_attention(q, kc, vc, pos + 1, cfg=cfg,
                                     kv_posit=cfg.kv_posit, ring=True)
        att = L.rms_norm(lp["attn_norm"], att.reshape(b, 1, cfg.n_heads * hd), cfg, mix)

        xs, gate, b_in, c_in, dt = _split_ssm_proj(lp, xin, cfg, mix)
        xh = xs[:, 0].reshape(b, cfg.ssm_heads, cfg.ssm_head_dim).to(_F32)
        y, hnew = ssd_step(xh, b_in[:, 0], c_in[:, 0], dt[:, 0],
                           _heads_of(lp["A_log"], cfg, mix), cache["ssm"][li])
        cache["ssm"][li] = hnew
        y = y + _heads_of(lp["D"], cfg, mix)[None, :, None] * xh
        y = y.reshape(b, 1, -1).to(h.dtype) * F.silu(gate)
        y = L.rms_norm(lp["ssm_norm"], y, cfg, mix)

        h = h + _merge(lp, att, y, cfg, mix)
        h = h + L.mlp(lp["mlp"], L.rms_norm(lp["ln2"], h, cfg), cfg, ff)

    h = L.rms_norm(params["final_norm"], h, cfg)
    y = h[:, 0, :] @ params["lm_head"]["w"].to(h.dtype)
    logits = y if tp is None else tp.gather_vocab(y)
    new_cache = dict(cache, len=pos + 1)
    if "lens" in cache:
        adv = torch.ones((b,), dtype=torch.int32, device=dev) if active is None \
            else torch.as_tensor(active, device=dev).to(torch.int32)
        new_cache["lens"] = cache["lens"] + adv
    return logits.to(_F32), new_cache


def prefill(params, tokens, cfg: ModelConfig, visual=None, *, max_len=None, tp=None):
    """``decode_step`` over the prompt (the hybrid caches' layouts differ
    per layer), as the reference's prefill.  ``max_len`` preallocates
    decode headroom (default: the window, or the prompt and one more);
    ``visual`` is accepted for the protocol and ignored.  Returns
    ``(cache, logits (B, V) f32)`` at the last position.  ``tp`` as in
    :func:`decode_step`."""
    del visual
    b, s = tokens.shape
    ml = max(s + 1, cfg.sliding_window or s + 1) if max_len is None \
        else int(max_len)
    if ml < s:
        raise ValueError(f"prefill max_len={ml} < prompt length {s}")
    cache = init_cache(cfg, b, ml, device=tokens.device)
    logits = None
    for t in range(s):
        logits, cache = decode_step(params, cache, tokens[:, t], cfg, tp=tp)
    return cache, logits
