"""RWKV6 "Finch": an attention-free LM with data-dependent decay, served
from an O(1) recurrent state.

The port of ``repro/models/rwkv6.py``: ``train_loss`` and ``logits_fn``
over whole sequences, and the serving entry points. Token-shift with
data-dependent mixing (5-way LoRA), the WKV recurrence ``S_t = diag(w_t)
S_{t-1} + k_t^T v_t``, ``out_t = r_t (S_{t-1} + diag(u) k_t^T v_t)``, a
layer norm over the heads' outputs, the output gate and the squared-ReLU
channel mix; decay ``w_t = exp(-exp(w0 + LoRA))``. Two WKV engines:
``wkv_scan`` (the step recurrence, decode) and ``wkv_chunked`` (chunk-
parallel in log-decay space, every exponent <= 0, prefill). Both run in
plain PyTorch, as the reference's run in plain ``jnp``: no posit kernel
is on this path.

There is no KV cache: the cache is the recurrent state, ``wkv`` (L, B,
H, N, N) f32 and the token-shift carries ``tm_x``/``cm_x`` (L, B, D),
stored f32 holding values rounded to the compute dtype, with the
frontier ``len`` a Python int. Decode updates the state in place. Layers
run in a Python loop over a list of per-layer parameter dicts.

Tensor-parallel serving: ``prefill`` and ``decode_step`` take ``tp``
(``runtime/collectives.TensorParallel``) and run on the rank-local config
(``sharding.local_config``) over this rank's shard.  Where the heads
split, the time mix runs this rank's heads (``wr``/``wk``/``wv``/``wg``
by columns, ``wo`` by rows, then the all-reduce), the ``wkv`` state
holds them, and ``w0``, ``u``, ``wl_b``'s columns and ``ln_x`` (whole on
every rank) are sliced to them; ``ln_x`` normalises over every head's
output (its f32 sums all-reduced).  Where ``d_ff`` splits, the channel
mix runs ``cm_wk``'s columns and ``cm_wv``'s rows, all-reduced before
the gate of ``cm_wr`` (whole).  The token-shift carries replicate; the
embedding and the head are vocabulary-parallel where the vocabulary
splits.

Tensor-parallel training: ``train_loss`` takes ``tp`` too and runs the
same layers under autograd, the inputs of the column-parallel products
through ``layers.enter``.  ``w0``, ``u``, ``wl_b`` and ``ln_x`` then hold
only this rank's heads' part of their gradient, which the train step
all-reduces (``sharding.partial_grad_leaves``); every other leaf gets
its own slice's or its whole gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from . import layers as L
from .config import ModelConfig

_F32 = torch.float32


def _heads(cfg: ModelConfig):
    n = cfg.head_dim                       # key/value head size (64)
    h = cfg.n_heads
    return h, n, h * n


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda", dtype=None,
                shard=None):
    """Random parameters from a seeded ``torch.Generator`` on ``device``:
    weights and mixing coefficients drawn in f32 and stored in ``dtype``
    (default the compute dtype; training passes ``torch.float32``), the
    layer norms, ``w0`` and ``u`` f32 (the forward reads them in f32).
    ``shard(subtree, prefix)`` cuts each layer and top-level leaf to this
    rank's shard as it is drawn (``transformer.init_params``)."""
    keep = shard or (lambda t, prefix: t)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    dt = L.cdtype(cfg) if dtype is None else dtype
    h, n, d_att = _heads(cfg)
    d, ff, lora = cfg.d_model, cfg.d_ff, cfg.decay_lora
    s = d ** -0.5

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev, dtype=_F32)
                * scale).to(dt)

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    layers = []
    for i in range(cfg.n_layers):
        layers.append(keep({
            "ln1": L.init_layer_norm(d, dev),
            "ln2": L.init_layer_norm(d, dev),
            # token-shift mixing coefficients + data-dependent LoRA
            "maa_x": zeros((d,)),
            "maa_wkvrg": zeros((5, d)),
            "tm_w1": normal((d, 5 * lora), s),
            "tm_w2": normal((5, lora, d), lora ** -0.5),
            # decay
            "w0": torch.full((d_att,), -6.0, dtype=_F32, device=dev),
            "wl_a": normal((d, lora), s),
            "wl_b": normal((lora, d_att), lora ** -0.5),
            "u": torch.zeros((h, n), dtype=_F32, device=dev),
            "wr": L.init_dense(gen, d, d_att, dtype=dt),
            "wk": L.init_dense(gen, d, d_att, dtype=dt),
            "wv": L.init_dense(gen, d, d_att, dtype=dt),
            "wg": L.init_dense(gen, d, d_att, dtype=dt),
            "ln_x": L.init_layer_norm(d_att, dev),
            "wo": L.init_dense(gen, d_att, d, dtype=dt),
            # channel mix
            "cm_maa_k": zeros((d,)),
            "cm_maa_r": zeros((d,)),
            "cm_wk": L.init_dense(gen, d, ff, dtype=dt),
            "cm_wv": L.init_dense(gen, ff, d, dtype=dt),
            "cm_wr": L.init_dense(gen, d, d, dtype=dt),
        }, f"layers/{i}"))
    return {
        "tok_embed": keep(normal((cfg.vocab, d), 0.02), "tok_embed"),
        "ln0": L.init_layer_norm(d, dev),
        "layers": layers,
        "ln_out": L.init_layer_norm(d, dev),
        "lm_head": keep(L.init_dense(gen, d, cfg.vocab, dtype=dt), "lm_head"),
    }


# ---------------------------------------------------------------------------
# WKV engines
# ---------------------------------------------------------------------------

def wkv_scan(r, k, v, w, u, state):
    """The step recurrence.  r, k, v, w: (B,S,H,N); u: (H,N); state:
    (B,H,N,N).  Returns (out (B,S,H,N), new state)."""
    outs = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]   # (B,H,N)
        kv = torch.einsum("bhk,bhv->bhkv", k_t, v_t)
        outs.append(torch.einsum("bhk,bhkv->bhv", r_t,
                                 state + u[None, :, :, None] * kv))
        state = w_t[..., None] * state + kv
    return torch.stack(outs, dim=1), state


def wkv_chunked(r, k, v, w, u, state, chunk: int):
    """Chunk-parallel WKV in log-decay space: the (C, C, N) ratio tensors
    of one chunk at a time, the state carried between chunks."""
    b, s, h, n = r.shape
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    lw = torch.log(torch.clamp(w, min=1e-38))                  # <= 0

    def shape(t):
        return t.reshape(b, nc, chunk, h, n).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = shape(r), shape(k), shape(v), shape(lw)  # (nc,B,H,C,N)
    cmask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=r.device), diagonal=-1)
    outs = []
    for ci in range(nc):
        rr, kk, vv, ll = rc[ci], kc[ci], vc[ci], lwc[ci]       # (B,H,C,N)
        li = torch.cumsum(ll, dim=2)                           # inclusive logs
        lx = li - ll                                           # exclusive
        # intra: A[c,j] = sum_n r[c] k[j] exp(lx[c] - li[j]),  j < c
        diff = lx[:, :, :, None, :] - li[:, :, None, :, :]     # (B,H,C,C,N)
        ratio = torch.where(cmask[None, None, :, :, None],
                            torch.exp(torch.clamp(diff, max=0.0)), 0.0)
        amat = torch.einsum("bhcn,bhjn,bhcjn->bhcj", rr, kk, ratio)
        # diagonal bonus term
        bonus = torch.einsum("bhcn,bhcn->bhc", rr * u[None, :, None, :], kk)
        out = torch.einsum("bhcj,bhjv->bhcv", amat, vv)
        out = out + bonus[..., None] * vv
        # inter: r[c] * exp(lx[c]) against the carried state
        out = out + torch.einsum("bhcn,bhnv->bhcv", rr * torch.exp(lx), state)
        # state update: S = exp(L_C) S + sum_j exp(L_C - li[j]) k_j^T v_j
        l_tot = li[:, :, -1:, :]                               # (B,H,1,N)
        kscale = kk * torch.exp(l_tot - li)
        state = torch.exp(l_tot[:, :, 0, :, None]) * state + torch.einsum(
            "bhjn,bhjv->bhnv", kscale, vv)
        outs.append(out)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, s, h, n)
    return out, state


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _token_shift(x, prev):
    """prev: (B,D) hidden of the token before this window."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _time_mix(p, x, prev_x, wkv_state, cfg: ModelConfig, *, use_chunked, tp=None):
    """``tp``: the plan where the heads split (``layers.split_plan``),
    ``cfg`` the rank-local config; the whole per-feature leaves are
    sliced to this rank's heads.  The inputs of ``wr``/``wk``/``wv``/
    ``wg`` and of ``wl_b``'s columns enter their column-parallel
    products (``layers.enter``), so that the mixing leaves before them
    get their whole gradient on every rank."""
    b, s, _ = x.shape
    h, n, d_att = _heads(cfg)
    r0 = 0 if tp is None else tp.rank
    xx = _token_shift(x, prev_x)
    sx = xx - x
    xxx = x + sx * p["maa_x"].to(x.dtype)
    mix = torch.tanh(xxx @ p["tm_w1"].to(x.dtype))            # (B,S,5*lora)
    mix = mix.reshape(b, s, 5, -1).permute(2, 0, 1, 3)
    mods = torch.einsum("fbsl,fld->fbsd", mix, p["tm_w2"].to(x.dtype))
    mods = mods + p["maa_wkvrg"][:, None, None, :].to(x.dtype)
    xw, xk, xv, xr, xg = (x + sx * m for m in mods.unbind(0))

    rr = L.dense(p["wr"], L.enter(xr, tp), cfg).reshape(b, s, h, n)
    kk = L.dense(p["wk"], L.enter(xk, tp), cfg).reshape(b, s, h, n)
    vv = L.dense(p["wv"], L.enter(xv, tp), cfg).reshape(b, s, h, n)
    gg = F.silu(L.dense(p["wg"], L.enter(xg, tp), cfg))

    w0, wl_b = p["w0"].narrow(0, r0 * d_att, d_att), p["wl_b"].narrow(1, r0 * d_att, d_att)
    lora = L.enter(torch.tanh(xw @ p["wl_a"].to(x.dtype)), tp)
    dlog = w0.to(_F32) + (lora @ wl_b.to(x.dtype)).to(_F32)
    w = torch.exp(-torch.exp(dlog)).reshape(b, s, h, n)       # in (0,1)

    rr32, kk32, vv32 = (t.to(_F32) for t in (rr, kk, vv))
    u = p["u"].narrow(0, r0 * h, h).to(_F32)
    if use_chunked:
        out, wkv_state = wkv_chunked(rr32, kk32, vv32, w, u, wkv_state,
                                     cfg.wkv_chunk)
    else:
        out, wkv_state = wkv_scan(rr32, kk32, vv32, w, u, wkv_state)

    out = out.reshape(b, s, d_att)
    out = L.layer_norm(p["ln_x"], out, cfg.norm_eps, tp).to(x.dtype)
    out = L.dense_row(p["wo"], out * gg, cfg, tp)
    return out, x[:, -1, :], wkv_state


def _channel_mix(p, x, prev_x, cfg: ModelConfig, tp=None):
    """``tp``: the plan where ``d_ff`` splits (``layers.split_plan``).
    ``cm_wr`` is whole on every rank and its input replicated; its gate
    multiplies ``cm_wv``'s product after the all-reduce, so it gets its
    whole gradient on every rank."""
    xx = _token_shift(x, prev_x)
    sx = xx - x
    xk = x + sx * p["cm_maa_k"].to(x.dtype)
    xr = x + sx * p["cm_maa_r"].to(x.dtype)
    kk = torch.square(F.relu(L.dense(p["cm_wk"], L.enter(xk, tp), cfg)))
    out = torch.sigmoid(L.dense(p["cm_wr"], xr, cfg)) * L.dense_row(p["cm_wv"], kk, cfg, tp)
    return out, x[:, -1, :]


# ---------------------------------------------------------------------------
# training loss and full-sequence logits
# ---------------------------------------------------------------------------

def _train_layer(lp, x, zeros_prev, zero_state, cfg: ModelConfig, use_chunked, tp=None):
    a, _, _ = _time_mix(lp, L.layer_norm(lp["ln1"], x, cfg.norm_eps), zeros_prev,
                        zero_state, cfg, use_chunked=use_chunked,
                        tp=L.split_plan(tp, "attn"))
    x = x + a
    c, _ = _channel_mix(lp, L.layer_norm(lp["ln2"], x, cfg.norm_eps), zeros_prev, cfg,
                        L.split_plan(tp, "mlp"))
    return x + c


def _forward(params, tokens, cfg: ModelConfig, *, use_chunked=True, tp=None):
    """The whole sequence from a zero state, each layer rematerialised
    in the backward pass under ``cfg.remat == "layer"`` (its forward
    collectives replay in the recompute, in the same order on every
    rank); returns the final layer norm's output (B, S, D).  ``tp``:
    this rank's plan, ``cfg`` then the rank-local config."""
    b = tokens.shape[0]
    h, n, _ = _heads(cfg)
    x = _embed(params, tokens.to(torch.int64), cfg, tp)
    zeros_prev = torch.zeros((b, cfg.d_model), dtype=x.dtype, device=x.device)
    zero_state = torch.zeros((b, h, n, n), dtype=_F32, device=x.device)
    for lp in params["layers"]:
        x = L.remat_layer(_train_layer, cfg, lp, x, zeros_prev, zero_state, cfg,
                          use_chunked, tp)
    return L.layer_norm(params["ln_out"], x, cfg.norm_eps)


def loss_labels(batch, cfg: ModelConfig):
    """``(labels, mask)`` of the next-token loss, the batch's ``"mask"``
    applied."""
    labels, mask = L.next_token_labels(batch["tokens"])
    if batch.get("mask") is not None:
        mask = mask * batch["mask"]
    return labels, mask


def train_loss(params, batch, cfg: ModelConfig, *, tp=None, denom=None):
    """Next-token cross entropy through the chunked WKV engine (the
    sequence a multiple of ``cfg.wkv_chunk``); ``denom`` divides the sum
    instead of the batch's own label count.  Under ``tp`` the
    parameters are this rank's shard, ``cfg`` the rank-local config and
    the loss vocabulary-parallel where the vocabulary splits."""
    x = _forward(params, batch["tokens"], cfg, tp=tp)
    labels, mask = loss_labels(batch, cfg)
    w = params["lm_head"]["w"].to(x.dtype)
    return L.chunked_xent(x, w, labels, mask, cfg.loss_chunk, denom=denom, tp=tp)


def logits_fn(params, tokens, cfg: ModelConfig, visual=None):
    """Full-sequence logits (B, S, V) f32 through the step recurrence
    (``wkv_scan``), as the reference's."""
    del visual
    x = _forward(params, tokens, cfg, use_chunked=False)
    return (x @ params["lm_head"]["w"].to(x.dtype)).to(_F32)


# ---------------------------------------------------------------------------
# serving: O(1) state instead of a KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    """Zero recurrent state; ``max_len`` is ignored (the state is O(1))."""
    del max_len
    dev = resolve_device(device)
    h, n, _ = _heads(cfg)
    lead = (cfg.n_layers, batch)
    return {
        "wkv": torch.zeros(lead + (h, n, n), dtype=_F32, device=dev),
        "tm_x": torch.zeros(lead + (cfg.d_model,), dtype=_F32, device=dev),
        "cm_x": torch.zeros(lead + (cfg.d_model,), dtype=_F32, device=dev),
        "len": 0,
    }


def _embed(params, tokens, cfg: ModelConfig, tp=None):
    table = params["tok_embed"]
    x = (table[tokens] if tp is None else tp.embed(table, tokens)).to(L.cdtype(cfg))
    return L.layer_norm(params["ln0"], x, cfg.norm_eps)


def _logits(params, x, cfg: ModelConfig, tp=None):
    x = L.layer_norm(params["ln_out"], x, cfg.norm_eps)
    y = x @ params["lm_head"]["w"].to(x.dtype)
    return y.to(_F32) if tp is None else tp.gather_vocab(y)


def decode_step(params, cache, token, cfg: ModelConfig, tp=None):
    """token (B,) -> (logits (B, V) f32, cache): one step of the scan
    recurrence, the state leaves updated in place.  ``tp``: this rank's
    tensor-parallel plan, ``cfg`` then the rank-local config."""
    x = _embed(params, token[:, None], cfg, tp)
    for li, lp in enumerate(params["layers"]):
        a, tm_new, wkv_s = _time_mix(
            lp, L.layer_norm(lp["ln1"], x, cfg.norm_eps),
            cache["tm_x"][li].to(x.dtype), cache["wkv"][li], cfg,
            use_chunked=False, tp=L.split_plan(tp, "attn"))
        x = x + a
        c, cm_new = _channel_mix(
            lp, L.layer_norm(lp["ln2"], x, cfg.norm_eps),
            cache["cm_x"][li].to(x.dtype), cfg, L.split_plan(tp, "mlp"))
        x = x + c
        cache["wkv"][li] = wkv_s
        cache["tm_x"][li] = tm_new.to(_F32)
        cache["cm_x"][li] = cm_new.to(_F32)
    return _logits(params, x[:, 0, :], cfg, tp), dict(cache, len=int(cache["len"]) + 1)


def prefill(params, tokens, cfg: ModelConfig, visual=None, *, max_len=None, tp=None):
    """The prompt's forward pass threading the recurrent state (the
    chunked WKV engine; the prompt length must be a multiple of
    ``cfg.wkv_chunk``).  ``visual`` and ``max_len`` are accepted for the
    protocol and ignored: there is no cache to preallocate and decode
    never runs out of capacity.  Returns ``(cache, logits (B, V) f32)``
    at the last position.  ``tp`` as in :func:`decode_step`."""
    del visual, max_len
    b, s = tokens.shape
    h, n, _ = _heads(cfg)
    x = _embed(params, tokens, cfg, tp)
    zeros_prev = torch.zeros((b, cfg.d_model), dtype=x.dtype, device=x.device)
    zero_state = torch.zeros((b, h, n, n), dtype=_F32, device=x.device)
    wkv, tm_x, cm_x = [], [], []
    for lp in params["layers"]:
        a, tm_new, wkv_s = _time_mix(
            lp, L.layer_norm(lp["ln1"], x, cfg.norm_eps), zeros_prev,
            zero_state, cfg, use_chunked=True, tp=L.split_plan(tp, "attn"))
        x = x + a
        c, cm_new = _channel_mix(
            lp, L.layer_norm(lp["ln2"], x, cfg.norm_eps), zeros_prev, cfg,
            L.split_plan(tp, "mlp"))
        x = x + c
        wkv.append(wkv_s)
        tm_x.append(tm_new.to(_F32))
        cm_x.append(cm_new.to(_F32))
    cache = {"wkv": torch.stack(wkv), "tm_x": torch.stack(tm_x),
             "cm_x": torch.stack(cm_x), "len": s}
    return cache, _logits(params, x[:, -1, :], cfg, tp)
