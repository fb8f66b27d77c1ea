"""Whisper-style encoder-decoder (the audio backbone; the conv frontend is
a stub: ``frames`` are precomputed frame embeddings (B, encoder_seq,
d_model)).

The port of ``repro/models/whisper.py``: ``train_loss`` and
``logits_fn`` over whole sequences, and the serving entry points. A
sinusoidal-position encoder with bidirectional attention, and a decoder
with learned positions, causal self-attention and cross-attention;
LayerNorm and GELU (the tanh form, ``jax.nn.gelu``'s default); the head
is tied to the token embedding.

The cache (``init_cache``): the self-attention leaves ``k``/``v`` (L, B,
max_len, G, D), the cross-attention leaves ``ck``/``cv`` (L, B,
encoder_seq, G, D), the shared frontier ``len`` and ``max_len`` as
Python ints and per-row ``lens``.  ``prefill`` encodes the frames and
quantizes each decoder layer's self and cross K and V through the codec
(``transformer._maybe_quant_kv``: four launches a layer on posit KV);
each decode layer writes its self K and V with one fused write launch,
then reads the self leaves and the cross leaves with one dequantize
launch each (``layers.decode_attention``).  Cache writes are in place.

Tensor-parallel serving: ``encode``, ``prefill`` and ``decode_step``
take ``tp`` (``runtime/collectives.TensorParallel``) and run on the
rank-local config (``sharding.local_config``) over this rank's shard:
the encoder's and decoder's self and cross attention on this rank's
heads (``wq``/``wv`` biases with their columns), the MLP on its
``d_ff`` columns, each row-parallel ``wo`` all-reduced before its bias
is added once.  Every rank encodes the frames to the whole encoder
output and computes its own heads' cross K and V from it; ``k``/``v``
and ``ck``/``cv`` hold this rank's KV heads.  The tied head is
vocabulary-parallel where the vocabulary splits.

Tensor-parallel training: ``train_loss`` takes ``tp`` too and runs the
same layers under autograd: the layer norms' outputs enter the
column-parallel ``wq``/``wk``/``wv`` and MLP ``wi`` (``layers.enter``),
and so does the encoder's output before each cross ``wk``/``wv``; the
row-parallel ``wo``s add their bias once after the sum.  No leaf is
whole on a rank yet sliced there, so every gradient is this rank's
slice's or the whole one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import types as PT
from repro_torch.device import resolve_device
from . import layers as L
from . import transformer as T
from .config import ModelConfig

_F32 = torch.float32


def _sinusoids(length: int, channels: int, device):
    t = torch.arange(length, dtype=_F32, device=device)[:, None]
    step = torch.log(torch.tensor(10000.0, dtype=_F32, device=device)) \
        / (channels // 2 - 1)
    inv = torch.exp(-torch.arange(channels // 2, dtype=_F32, device=device) * step)
    ang = t * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _init_attn(gen, cfg: ModelConfig, dt):
    d = cfg.d_model
    return {
        "wq": L.init_dense(gen, d, cfg.n_heads * cfg.head_dim, dtype=dt, bias=True),
        "wk": L.init_dense(gen, d, cfg.n_kv_heads * cfg.head_dim, dtype=dt),
        "wv": L.init_dense(gen, d, cfg.n_kv_heads * cfg.head_dim, dtype=dt, bias=True),
        "wo": L.init_dense(gen, cfg.n_heads * cfg.head_dim, d, dtype=dt, bias=True),
    }


def _init_mlp(gen, cfg: ModelConfig, dt):
    return {
        "wi": L.init_dense(gen, cfg.d_model, cfg.d_ff, dtype=dt, bias=True),
        "wo": L.init_dense(gen, cfg.d_ff, cfg.d_model, dtype=dt, bias=True),
    }


def _mlp(p, x, cfg: ModelConfig, tp=None):
    """``tp``: the plan where ``d_ff`` splits (``layers.split_plan``)."""
    return L.dense_row(p["wo"], F.gelu(L.dense(p["wi"], x, cfg), approximate="tanh"),
                       cfg, tp)


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda", dtype=None,
                shard=None):
    """Random parameters from a seeded ``torch.Generator`` on ``device``:
    weights, dense biases and embeddings drawn in f32 and stored in
    ``dtype`` (default the compute dtype; training passes
    ``torch.float32``), the layer norms f32.  ``enc_layers`` and
    ``dec_layers`` are lists of per-layer dicts.  ``shard(subtree,
    prefix)`` cuts each layer and top-level leaf to this rank's shard as
    it is drawn (``transformer.init_params``)."""
    keep = shard or (lambda t, prefix: t)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    dt = L.cdtype(cfg) if dtype is None else dtype
    d = cfg.d_model

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev, dtype=_F32)
                * scale).to(dt)

    n_enc = cfg.encoder_layers or cfg.n_layers
    enc = [keep({"ln1": L.init_layer_norm(d, dev), "attn": _init_attn(gen, cfg, dt),
                 "ln2": L.init_layer_norm(d, dev), "mlp": _init_mlp(gen, cfg, dt)},
                f"enc_layers/{i}")
           for i in range(n_enc)]
    dec = [keep({"ln1": L.init_layer_norm(d, dev), "self": _init_attn(gen, cfg, dt),
                 "ln_x": L.init_layer_norm(d, dev), "cross": _init_attn(gen, cfg, dt),
                 "ln2": L.init_layer_norm(d, dev), "mlp": _init_mlp(gen, cfg, dt)},
                f"dec_layers/{i}")
           for i in range(cfg.n_layers)]
    return {
        "enc_layers": enc,
        "enc_ln": L.init_layer_norm(d, dev),
        "tok_embed": keep(normal((cfg.vocab, d), 0.02), "tok_embed"),
        "pos_embed": normal((4096 * 8, d), 0.01),
        "dec_layers": dec,
        "dec_ln": L.init_layer_norm(d, dev),
    }


def _qkv(p, x, cfg: ModelConfig, tp=None, kv_in=None):
    """This rank's query heads from ``x`` and K/V heads from ``kv_in``
    (default ``x``).  ``tp``: the plan where the heads split; in training
    the inputs enter their column-parallel products (one whole KV
    head's K and V enter instead, as every rank's heads read them)."""
    b, s, _ = x.shape
    xq = L.enter(x, tp)
    kv_split = tp is not None and tp.kv
    if kv_in is None:
        xkv = xq if kv_split else x
    else:
        xkv = L.enter(kv_in, tp) if kv_split else kv_in
    t = xkv.shape[1]
    q = L.dense(p["wq"], xq, cfg).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = L.dense(p["wk"], xkv, cfg).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = L.dense(p["wv"], xkv, cfg).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    if tp is not None and not kv_split:
        k, v = tp.enter(k), tp.enter(v)
    return q, k, v


def encode(params, frames, cfg: ModelConfig, tp=None):
    """frames: (B, T_enc, d) precomputed embeddings (the conv stub's
    output) -> the encoder's output (B, T_enc, d), whole on every rank
    under ``tp``."""
    x = frames.to(L.cdtype(cfg))
    x = x + _sinusoids(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
    for lp in params["enc_layers"]:
        x = L.remat_layer(_enc_layer, cfg, lp, x, cfg, tp)
    return L.layer_norm(params["enc_ln"], x)


def _enc_layer(lp, x, cfg: ModelConfig, tp=None):
    b, t_enc, _ = x.shape
    heads, ff = L.split_plan(tp, "attn"), L.split_plan(tp, "mlp")
    q, k, v = _qkv(lp["attn"], L.layer_norm(lp["ln1"], x), cfg, heads)
    a = L.flash_attention(q, k, v, causal=False, cfg=cfg).reshape(b, t_enc, -1)
    x = x + L.dense_row(lp["attn"]["wo"], a, cfg, heads)
    return x + _mlp(lp["mlp"], L.enter(L.layer_norm(lp["ln2"], x), ff), cfg, ff)


def _dec_layer(lp, x, enc_out, cfg: ModelConfig, tp=None):
    """One decoder layer over the whole sequence: causal self-attention,
    cross-attention to ``enc_out``, the MLP.  ``tp``: this rank's plan,
    ``cfg`` then the rank-local config."""
    b, s, _ = x.shape
    heads, ff = L.split_plan(tp, "attn"), L.split_plan(tp, "mlp")
    q, k, v = _qkv(lp["self"], L.layer_norm(lp["ln1"], x), cfg, heads)
    a = L.flash_attention(q, k, v, causal=True, cfg=cfg)
    x = x + L.dense_row(lp["self"]["wo"], a.reshape(b, s, -1), cfg, heads)
    q, ek, ev = _qkv(lp["cross"], L.layer_norm(lp["ln_x"], x), cfg, heads, kv_in=enc_out)
    c = L.flash_attention(q, ek, ev, causal=False, cfg=cfg)
    x = x + L.dense_row(lp["cross"]["wo"], c.reshape(b, s, -1), cfg, heads)
    return x + _mlp(lp["mlp"], L.enter(L.layer_norm(lp["ln2"], x), ff), cfg, ff)


def _decoder(params, tokens, enc_out, cfg: ModelConfig, tp=None):
    """The decoder over whole sequences (training and ``logits_fn``),
    each layer rematerialised in the backward pass under ``cfg.remat ==
    "layer"``; returns the final layer norm's output (B, S, D)."""
    s = tokens.shape[1]
    x = _embed(params, tokens.to(torch.int64), cfg, tp)
    x = x + params["pos_embed"][:s].to(x.dtype)[None]
    for lp in params["dec_layers"]:
        x = L.remat_layer(_dec_layer, cfg, lp, x, enc_out, cfg, tp)
    return L.layer_norm(params["dec_ln"], x)


def loss_labels(batch, cfg: ModelConfig):
    """``(labels, mask)`` of the next-token loss; a ``"mask"`` is
    ignored, as in the reference."""
    return L.next_token_labels(batch["tokens"])


def train_loss(params, batch, cfg: ModelConfig, *, tp=None, denom=None):
    """batch: ``{"tokens": (B, S), "frames": (B, T_enc, D)}``.  The head
    is tied; ``denom`` divides the sum instead of the batch's own label
    count.  Under ``tp`` the parameters are this rank's shard, ``cfg``
    the rank-local config and the tied head vocabulary-parallel where
    the vocabulary splits."""
    tokens = batch["tokens"]
    x = _decoder(params, tokens, encode(params, batch["frames"], cfg, tp), cfg, tp)
    labels, mask = loss_labels(batch, cfg)
    w = params["tok_embed"].T.to(x.dtype)
    return L.chunked_xent(x, w, labels, mask, cfg.loss_chunk, denom=denom, tp=tp)


def logits_fn(params, tokens, cfg: ModelConfig, frames=None):
    """Full-sequence logits (B, S, V) f32."""
    x = _decoder(params, tokens, encode(params, frames, cfg), cfg)
    return (x @ params["tok_embed"].T.to(x.dtype)).to(_F32)


def _logits(params, x, tp=None):
    x = L.layer_norm(params["dec_ln"], x)
    y = x @ params["tok_embed"].T.to(x.dtype)                  # the tied head
    return y.to(_F32) if tp is None else tp.gather_vocab(y)


def _embed(params, tokens, cfg: ModelConfig, tp=None):
    table = params["tok_embed"]
    return (table[tokens] if tp is None else tp.embed(table, tokens)).to(L.cdtype(cfg))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    dev = resolve_device(device)
    dt = T._cache_dtype(cfg)
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    ckv = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": PT.zeros(kv, dt, dev), "v": PT.zeros(kv, dt, dev),
        "ck": PT.zeros(ckv, dt, dev), "cv": PT.zeros(ckv, dt, dev),
        "len": 0,
        "lens": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "max_len": int(max_len),
    }


def _stack(leaves):
    """Stack per-layer leaves (posit patterns included) on a new axis 0."""
    return torch.stack([PT.signed_view(t) for t in leaves]).view(leaves[0].dtype)


def prefill(params, tokens, cfg: ModelConfig, frames=None, *, max_len=None, tp=None):
    """Encode the frames, compute every decoder layer's cross-attention K
    and V once, and run the prompt through the decoder caching its
    self-attention K and V; returns ``(cache, logits (B, V) f32)`` at the
    last position.  ``max_len`` preallocates decode headroom on the
    self-attention cache (default: the prompt's length).  ``tp``: this
    rank's tensor-parallel plan, ``cfg`` then the rank-local config."""
    b, s = tokens.shape
    ml = s if max_len is None else int(max_len)
    if ml < s:
        raise ValueError(f"prefill max_len={ml} < prompt length {s}")
    heads, ff = L.split_plan(tp, "attn"), L.split_plan(tp, "mlp")
    enc_out = encode(params, frames, cfg, tp)
    t_enc = enc_out.shape[1]
    g, hd = cfg.n_kv_heads, cfg.head_dim
    x = _embed(params, tokens, cfg, tp)
    x = x + params["pos_embed"][:s].to(x.dtype)[None]
    stored = ([], [], [], [])                        # k, v, ck, cv per layer
    for lp in params["dec_layers"]:
        q, k, v = _qkv(lp["self"], L.layer_norm(lp["ln1"], x), cfg)
        a = L.flash_attention(q, k, v, causal=True, cfg=cfg)
        x = x + L.dense_row(lp["self"]["wo"], a.reshape(b, s, -1), cfg, heads)
        xin = L.layer_norm(lp["ln_x"], x)
        q = L.dense(lp["cross"]["wq"], xin, cfg).reshape(b, s, cfg.n_heads, hd)
        ek = L.dense(lp["cross"]["wk"], enc_out, cfg).reshape(b, t_enc, g, hd)
        ev = L.dense(lp["cross"]["wv"], enc_out, cfg).reshape(b, t_enc, g, hd)
        c = L.flash_attention(q, ek, ev, causal=False, cfg=cfg)
        x = x + L.dense_row(lp["cross"]["wo"], c.reshape(b, s, -1), cfg, heads)
        x = x + _mlp(lp["mlp"], L.layer_norm(lp["ln2"], x), cfg, ff)
        for acc, t in zip(stored, (k, v, ek, ev)):
            acc.append(T._maybe_quant_kv(t, cfg))
    ks, vs, cks, cvs = (_stack(acc) for acc in stored)
    dev = tokens.device
    cache = {"k": L.pad_cache_time(ks, ml), "v": L.pad_cache_time(vs, ml),
             "ck": cks, "cv": cvs, "len": s,
             "lens": torch.full((b,), s, dtype=torch.int32, device=dev),
             "max_len": ml}
    return cache, _logits(params, x[:, -1, :], tp)


def decode_step(params, cache, token, cfg: ModelConfig, tp=None):
    """token (B,) -> (logits (B, V) f32, cache): every row writes its
    self K and V at the shared frontier ``len`` (a write past the
    capacity raises here), then attends over the self cache and the
    whole cross cache.  ``tp`` as in :func:`prefill`."""
    pos = int(cache["len"])
    b = token.shape[0]
    L.check_cache_capacity(pos, cache["k"].shape[2], "decoder self-attention cache")
    heads, ff = L.split_plan(tp, "attn"), L.split_plan(tp, "mlp")
    x = _embed(params, token, cfg, tp)[:, None, :]
    x = x + params["pos_embed"][pos].to(x.dtype)
    slots = L.linear_write_slots(b, cache["k"].shape[2], pos, ring=False,
                                 device=token.device)
    for li, lp in enumerate(params["dec_layers"]):
        q, k, v = _qkv(lp["self"], L.layer_norm(lp["ln1"], x), cfg)
        kc, vc = cache["k"][li], cache["v"][li]
        T._write_kv([(kc, k[:, 0]), (vc, v[:, 0])], slots, cfg, dense=True)
        a = L.decode_attention(q, kc, vc, pos + 1, cfg=cfg, kv_posit=cfg.kv_posit)
        x = x + L.dense_row(lp["self"]["wo"], a.reshape(b, 1, -1), cfg, heads)
        xin = L.layer_norm(lp["ln_x"], x)
        q = L.dense(lp["cross"]["wq"], xin, cfg).reshape(
            b, 1, cfg.n_heads, cfg.head_dim)
        ck, cv = cache["ck"][li], cache["cv"][li]
        c = L.decode_attention(q, ck, cv, ck.shape[1], cfg=cfg, kv_posit=cfg.kv_posit)
        x = x + L.dense_row(lp["cross"]["wo"], c.reshape(b, 1, -1), cfg, heads)
        x = x + _mlp(lp["mlp"], L.layer_norm(lp["ln2"], x), cfg, ff)
    new_cache = dict(cache, len=pos + 1)
    if "lens" in cache:
        new_cache["lens"] = cache["lens"] + 1
    return _logits(params, x[:, 0, :], tp), new_cache
