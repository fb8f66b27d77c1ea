"""Shared neural layers on torch tensors (the serving and training paths).

Conventions follow ``repro/models/layers.py``: params are plain dicts of
tensors; activations run in ``cfg.compute_dtype`` and every weight is
cast to the activation dtype at use (posit-pattern weights decode first,
``maybe_dequant``; ``cfg.posit_exact_linear`` routes ``dense`` through
the quire, ``dense_posit_exact``); attention is the chunked online-
softmax ``flash_attention`` with its fixed ``attn_chunk_kv`` KV grouping
(the chunked-prefill identity depends on it).  The feed-forward is the
SwiGLU/GeGLU ``mlp`` or the mixture of experts ``moe`` (the reference's
row-local sort-based capacity dispatch, vectorised over rows, with no
host sync; the experts' products as batched matmuls).

Linear caches (a shared write frontier, the window ring written at
``pos % T``) decode through ``decode_attention`` over the whole
dequantized cache (a layer's two posit leaves in one codec launch);
their writes never clamp (``check_cache_capacity``,
``linear_write_slots``).  Paged KV primitives (block arenas + per-row
block tables, sentinel ``n_blocks``, row-local addressing, the
sliding-window block ring) keep the reference's layout contract.  Where
the reference scatters with ``mode="drop"``, the port computes which
writes land first and scatters only those; reads through sentinel
entries clamp into block ``nb - 1`` and are masked by ``paged_apos``.
Cache writes are in place.

Tensor parallelism (``runtime/collectives.TensorParallel``): ``dense_row``
is a row-parallel ``dense`` (the all-reduce, then the bias once),
``mlp`` takes the plan where ``d_ff`` splits, and ``rms_norm`` and
``layer_norm`` normalise over features split across the ranks;
``split_plan`` gives a call the plan where its group splits, and
``enter`` marks a column-parallel product's input for training.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import POSIT8, POSIT16, index_rows, signed_view, zeros
from repro_torch.kernels import ops, posit_codec
from .config import ModelConfig

_PCFGS = {"posit16": POSIT16, "posit8": POSIT8}
_NEG = -1e30


def pcfg(name: str):
    return _PCFGS[name]


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)


def maybe_dequant(w, cfg: ModelConfig):
    """Posit-quantized weights (unsigned patterns) decode on the fly."""
    if w.dtype in _UNSIGNED:
        return posit_codec.dequantize(w.contiguous(),
                                      pcfg(cfg.weight_posit or "posit16"))
    return w


def dense(p, x, cfg: ModelConfig):
    if cfg.posit_exact_linear:
        return dense_posit_exact(p, x, cfg)
    y = x @ maybe_dequant(p["w"], cfg).to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def dense_posit_exact(p, x, cfg: ModelConfig):
    """Bit-exact posit linear for numerics audits (``cfg.posit_exact_linear``).

    The paper's §IV-E datapath end to end in the posit domain: the
    activations quantize once, ``kernels.ops.pgemm`` reduces every output
    through the quire (one rounding each), the bias adds with the fused
    ``vadd`` and the result dequantizes once -- three roundings per
    output whatever K is.  The ground truth the float ``dense`` is
    audited against; far slower, never on a serving path.
    """
    pc = pcfg(cfg.weight_posit or "posit16")
    w = p["w"]
    wq = w if w.dtype in _UNSIGNED else ops.quantize(w.to(torch.float32), pc)
    yq = ops.pgemm(ops.quantize(x.to(torch.float32), pc), wq, pc)
    if "b" in p:
        yq = ops.vadd(yq, ops.quantize(p["b"].to(torch.float32), pc), pc)
    return ops.dequantize(yq, pc).to(x.dtype)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, *,
               dtype=torch.float32, scale=None, bias: bool = False):
    scale = (d_in ** -0.5) if scale is None else scale
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32) * scale
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def split_plan(tp, group: str):
    """``tp`` (``runtime/collectives.TensorParallel``) where its ``group``
    (``"attn"``, ``"mlp"``, ...) splits, else ``None``: the plan a
    call on that group's rank-local share takes."""
    return tp if tp is not None and getattr(tp, group) else None


def enter(x, tp=None):
    """``x`` as the input of a column-parallel product under ``tp`` (its
    gradient all-reduced in the backward pass, ``TensorParallel.enter``);
    ``x`` itself without a plan."""
    return x if tp is None else tp.enter(x)


def dense_row(p, x, cfg: ModelConfig, tp=None):
    """A row-parallel ``dense``: under ``tp`` this rank's rows' partial
    product, the all-reduce, then the bias once; ``dense`` without."""
    if tp is None:
        return dense(p, x, cfg)
    y = tp.reduce(dense({"w": p["w"]}, x, cfg))
    return y + p["b"].to(y.dtype) if "b" in p else y


def _feature_mean(x, tp):
    """The mean over the last axis, whose features split over ``tp``'s
    ranks when it is given (the f32 sums all-reduced)."""
    if tp is None:
        return torch.mean(x, dim=-1, keepdim=True)
    return tp.feature_sum(torch.sum(x, dim=-1, keepdim=True)) / (x.shape[-1] * tp.size)


def _local_features(v, n: int, tp):
    """This rank's ``n`` features of a whole per-feature vector ``v``."""
    return v if tp is None else v.narrow(0, tp.rank * n, n)


def rms_norm(p, x, cfg: ModelConfig, tp=None):
    """RMS norm over the last axis; under ``tp`` the features split over
    its ranks (``x`` this rank's share, ``p`` whole): the mean square is
    the group's, the scale this rank's slice."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = _feature_mean(x * x, tp)
    x = x * torch.rsqrt(var + cfg.norm_eps)
    w = _local_features(p["scale"].to(torch.float32), x.shape[-1], tp)
    if cfg.norm_plus_one:
        w = 1.0 + w
    return (x * w).to(dt)


def init_rms_norm(d: int, cfg: ModelConfig, device):
    init = torch.zeros if cfg.norm_plus_one else torch.ones
    return {"scale": init((d,), dtype=torch.float32, device=device)}


def layer_norm(p, x, eps: float = 1e-5, tp=None):
    """Layer norm over the last axis, the mean first, then the squared
    deviations; under ``tp`` split features as in :func:`rms_norm`."""
    dt = x.dtype
    x = x.to(torch.float32)
    n = x.shape[-1]
    mu = _feature_mean(x, tp)
    var = _feature_mean((x - mu) ** 2, tp)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * _local_features(p["scale"], n, tp) + _local_features(p["bias"], n, tp)).to(dt)


def init_layer_norm(d: int, device):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(dim: int, theta: float, device=None):
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D) with D even; positions: (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked flash attention (online softmax over fixed KV blocks)
# ---------------------------------------------------------------------------

def _pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target."""
    c = min(target, n)
    while n % c:
        c -= 1
    return c


def flash_attention(q, k, v, *, causal: bool, cfg: ModelConfig,
                    window: int = 0, q_offset: int = 0, kv_mask=None,
                    q_positions=None):
    """q: (B,S,H,D); k,v: (B,T,G,D[v]) grouped-query; returns (B,S,H,Dv).

    ``causal`` masks keys past each query's position; ``window`` keys
    ``window`` or more behind it.  ``kv_mask`` (B, T) bool, optional,
    excludes keys per row; ``q_positions`` (B, S), optional, gives each
    query its absolute position (chunked prefill: every row sits at its
    own frontier), by default ``q_offset + arange(S)`` for every row.
    KV is padded to a multiple of ``cfg.attn_chunk_kv`` (the padding
    masked) so KV block ``i`` always covers positions ``[i*kc, (i+1)*kc)``:
    a whole-prompt prefill and a chunked one reduce in the same groups.
    """
    b, s_len, h, d = q.shape
    t_len, g = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    r = h // g
    scale = d ** -0.5
    qc = _pick_chunk(s_len, cfg.attn_chunk_q)
    kc = int(cfg.attn_chunk_kv)
    t_pad = -(-t_len // kc) * kc
    if t_pad != t_len:
        pad = t_pad - t_len
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_mask is None:
            kv_mask = torch.ones((b, t_len), dtype=torch.bool, device=q.device)
        kv_mask = F.pad(kv_mask, (0, pad))
    if q_positions is None:
        q_positions = (q_offset + torch.arange(s_len, device=q.device))[None, :].expand(
            b, s_len)
    n_q, n_k = s_len // qc, t_pad // kc

    qg = q.reshape(b, n_q, qc, g, r, d).permute(1, 0, 3, 4, 2, 5) * scale
    kg = k.reshape(b, n_k, kc, g, d).permute(1, 0, 3, 2, 4)
    vg = v.reshape(b, n_k, kc, g, dv).permute(1, 0, 3, 2, 4)
    km = None if kv_mask is None else kv_mask.reshape(b, n_k, kc).permute(1, 0, 2)
    q_pos = q_positions.to(torch.int64).reshape(b, n_q, qc).permute(1, 0, 2)
    k_pos = torch.arange(t_pad, device=q.device).reshape(n_k, kc)

    outs = []
    for qi in range(n_q):
        qblk, qp = qg[qi], q_pos[qi]                       # qp: (B, qc)
        m = torch.full((b, g, r, qc), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, g, r, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, g, r, qc, dv), dtype=torch.float32, device=q.device)
        for ki in range(n_k):
            kblk, vblk, kp = kg[ki], vg[ki], k_pos[ki]
            sblk = torch.einsum("bgrqd,bgkd->bgrqk", qblk, kblk).to(torch.float32)
            if causal or window:
                bias = torch.where(qp[:, :, None] >= kp, 0.0, _NEG) if causal else 0.0
                if window:
                    bias = bias + torch.where(qp[:, :, None] - kp < window, 0.0, _NEG)
                sblk = sblk + bias[:, None, None]            # (B,1,1,qc,kc)
            if km is not None:
                sblk = torch.where(km[ki][:, None, None, None, :], sblk, _NEG)
            m_new = torch.maximum(m, sblk.amax(-1))
            p = torch.exp(sblk - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bgrqk,bgkv->bgrqv", p.to(vblk.dtype), vblk).to(torch.float32)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs)                                 # (nq,B,G,R,qc,Dv)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, s_len, h, dv)
    return out.to(q.dtype)


def _per_row(x, b: int, device) -> torch.Tensor:
    """A scalar or (B,) position as a (B,) int64 tensor."""
    x = torch.as_tensor(x, device=device).to(torch.int64)
    return x.expand(b) if x.ndim == 0 else x


def decode_positions(cache_len, t_len: int, *, ring: bool = False):
    """(B,) write frontiers ``cache_len`` -> (B, T) absolute position of
    every slot of a linear cache (slot ``t`` holds position ``t``) or a
    ring of capacity T written at ``pos % T`` (slot ``i`` holds
    ``p - fmod(p - i, T)`` for the frontier ``p = cache_len - 1``;
    slots ahead of it get positions past the frontier, unwritten ones
    negative)."""
    t_pos = torch.arange(t_len, dtype=torch.int64, device=cache_len.device)
    if ring:
        p = (cache_len - 1)[:, None]
        return p - torch.fmod(p - t_pos[None, :], t_len)
    return t_pos[None, :].expand(cache_len.shape[0], t_len)


def decode_attention(q, k_cache, v_cache, cache_len, *, cfg: ModelConfig,
                     kv_posit: Optional[str] = None, window: int = 0,
                     start=None, ring: bool = False, apos=None):
    """Single-token decode: q (B,1,H,D); caches (B,T,G,D) possibly posit
    patterns, dequantized whole.  ``cache_len`` (scalar or (B,)) is the
    visible length, ``start`` (scalar or (B,), default 0) the first valid
    position (a left-padded row's offset).  Slot positions come from
    ``apos`` (B,T) (the paged lanes; ``-1`` dead) or, without it, from
    :func:`decode_positions` on a linear or ``ring`` cache."""
    b, _, h, d = q.shape
    g = k_cache.shape[2]
    r = h // g
    scale = d ** -0.5
    # the caches as f32 values of the compute dtype: a posit cache in one
    # launch for both leaves, each value rounded through bf16 on its way
    # when that is the compute dtype
    if kv_posit is not None:
        ks, vs = posit_codec.dequantize_many(
            [k_cache.contiguous(), v_cache.contiguous()], pcfg(kv_posit),
            round_to=None if cdtype(cfg) == torch.float32 else cdtype(cfg))
    else:
        ks = k_cache.to(cdtype(cfg)).to(torch.float32)
        vs = v_cache.to(cdtype(cfg)).to(torch.float32)

    qg = (q.reshape(b, g, r, d) * scale).to(cdtype(cfg))
    # products of compute-dtype operands, accumulated in f32
    scores = torch.einsum("bgrd,btgd->bgrt", qg.to(torch.float32), ks)
    cl = _per_row(cache_len, b, q.device)
    st = _per_row(0 if start is None else start, b, q.device)
    if apos is None:
        apos = decode_positions(cl, k_cache.shape[1], ring=ring)
    apos = apos.to(torch.int64)
    cl = cl[:, None]
    valid = (apos < cl) & (apos >= st[:, None])
    if ring:
        valid &= apos >= 0                                  # unwritten slots
    if window:
        valid &= apos >= cl - window
    valid = valid[:, None, None, :]
    scores = torch.where(valid, scores, _NEG)
    m = scores.amax(-1, keepdim=True)
    # all-masked guard: invalid slots get p = 0, so a row with no valid
    # slot finalizes to exact zeros instead of a uniform average
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    l = p.sum(-1)
    out = torch.einsum("bgrt,btgv->bgrv", p.to(cdtype(cfg)).to(torch.float32),
                       vs)
    out = out / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, 1, h, -1).to(q.dtype)


# ---------------------------------------------------------------------------
# Linear (and ring) caches: guarded decode writes and slot-pool surgery
#
# A linear cache leaf is (L, B, T, ...): one shared write frontier
# ``len`` (a Python int), per-row valid counts ``lens``.  Decode writes
# never clamp: a write past the capacity raises eagerly
# (``check_cache_capacity``) or, through the write slots, drops.
# ---------------------------------------------------------------------------

def check_cache_capacity(pos, capacity: int, what: str = "KV cache"):
    """Raise on a decode position past the cache capacity."""
    if int(pos) >= capacity:
        raise ValueError(
            f"decode_step past {what} capacity: position {int(pos)} >= "
            f"{capacity}. Preallocate headroom with init_cache(..., "
            "max_len) / prefill(..., max_len=...) or use "
            "repro_torch.runtime.engine.Engine, which sizes caches up front.")


def guarded_cache_update(arr, upd, idx: int, axis: int):
    """Write ``upd`` (extent 1 on ``axis``) at ``idx`` of ``axis``, in
    place; a write at ``idx >= capacity`` leaves ``arr`` unchanged
    instead of clamping onto the last slot.  Returns ``arr``."""
    if 0 <= int(idx) < arr.shape[axis]:
        signed_view(arr).narrow(axis, int(idx), 1).copy_(signed_view(upd))
    return arr


def linear_write_slots(batch: int, capacity: int, pos: int, *, ring: bool,
                       device):
    """Where each row's decode write lands in one layer's linear leaf
    (B, T, ...) seen as an arena of B blocks of T slots: the flat slot
    ``b * T + (pos % T if ring else pos)``, or -1 for every row when a
    linear write would land past the capacity (dropped)."""
    if ring:
        slot = int(pos) % capacity
    elif int(pos) >= capacity:
        return torch.full((batch,), -1, dtype=torch.int64, device=device)
    else:
        slot = int(pos)
    return torch.arange(batch, dtype=torch.int64, device=device) * capacity + slot


def roll_cache_time(kv, shift: int):
    """Circularly shift a stacked-layer KV time axis (L, B, T, ...) by
    ``shift`` slots: the one primitive behind compaction and admission
    (content at ``[len - l, len)`` moves to ``[len + shift - l, ...)``;
    on a ring of capacity T it relabels slot ``q % T`` to
    ``(q + shift) % T``)."""
    return torch.roll(signed_view(kv), int(shift), dims=2).view(kv.dtype)


def reset_cache_rows(kv, row_mask, batch_axis: int = 1):
    """Zero the batch rows of a stacked cache leaf where ``row_mask``
    (B,) is True, in place; returns ``kv``."""
    rows = torch.nonzero(torch.as_tensor(row_mask).to(torch.bool))[:, 0].tolist()
    if rows:
        signed_view(kv).index_fill_(
            batch_axis, torch.tensor(rows, device=kv.device), 0)
    return kv


def pad_cache_time(kv, t: int):
    """Zero-pad the stacked-layer KV time axis (L, B, S, ...) up to
    ``t``: an exactly prompt-sized cache with decode headroom."""
    s = kv.shape[2]
    if s == t:
        return kv
    out = zeros(kv.shape[:2] + (t,) + kv.shape[3:], kv.dtype, kv.device)
    signed_view(out)[:, :, :s] = signed_view(kv)
    return out


# ---------------------------------------------------------------------------
# Paged KV cache primitives (block arenas + per-row block tables)
#
# Arena leaves are (n_blocks, block_size, ...) per layer, (L, n_blocks,
# block_size, ...) stacked; ``block_tables`` is (B, W) int32 with the
# sentinel ``n_blocks`` in unassigned entries.  Row b's token p lives in
# logical block ``p // block_size`` at offset ``p % block_size``.  The
# dense lane maps logical block i to table slot i; the sliding-window
# lane maps logical block q to slot ``q % W`` with
# ``W = ceil(window / block_size) + 1``.
# ---------------------------------------------------------------------------

def paged_window_blocks(window: int, block_size: int) -> int:
    """Table width of the sliding-window block ring."""
    return -(-window // block_size) + 1


def paged_is_window_lane(window: int, block_size: int,
                         table_width: int) -> bool:
    """A paged cache runs the block ring iff its table width is the
    window ring's."""
    return bool(window) and table_width == paged_window_blocks(
        window, block_size)


def paged_positions(frontier, table_width: int, block_size: int, *,
                    window: int = 0):
    """(B,) frontier (last-written position) -> (B, W*bs) int32 absolute
    position of every virtual slot (window lane: slot s holds logical
    block ``pb - fmod(pb - s, W)``)."""
    w, bs = table_width, block_size
    frontier = torch.as_tensor(frontier).to(torch.int32)
    b = frontier.shape[0]
    dev = frontier.device
    offs = torch.arange(bs, dtype=torch.int32, device=dev)
    if paged_is_window_lane(window, bs, w):
        pb = torch.div(frontier[:, None], bs, rounding_mode="floor")
        sblk = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
        lb = pb - torch.fmod(pb - sblk, w)
        apos = lb[:, :, None] * bs + offs[None, None, :]
    else:
        blk = torch.arange(w, dtype=torch.int32, device=dev)
        apos = (blk[:, None] * bs + offs[None, :])[None].expand(b, w, bs)
    return apos.reshape(b, w * bs)


def paged_gather(arena, tables):
    """arena (nb, bs, ...) + tables (B, W) -> (B, W*bs, ...); sentinel
    entries clamp into block ``nb - 1`` (masked by the caller)."""
    nb, bs = arena.shape[0], arena.shape[1]
    b, w = tables.shape
    g = index_rows(arena, tables.to(torch.int64).clamp(0, nb - 1))
    return g.reshape((b, w * bs) + tuple(arena.shape[2:]))


def paged_apos(tables, lens, block_size: int, n_blocks: int, *,
               window: int = 0):
    """Per-slot absolute positions with sentinel-backed slots ``-1``: the
    one masking contract both paged decode paths consume."""
    w = tables.shape[1]
    apos = paged_positions(lens, w, block_size, window=window)
    live = (tables < n_blocks).repeat_interleave(block_size, dim=1)
    return torch.where(live, apos, -1).to(torch.int32)


def decode_attention_paged(q, k_arena, v_arena, tables, lens, *,
                           cfg: ModelConfig, kv_posit: Optional[str] = None,
                           window: int = 0, kernel: str = "gather"):
    """Paged decode attention off the block tables.

    q: (B, 1, H, D); arenas (n_blocks, bs, G, D[v]); tables (B, W) int32;
    lens (B,) int32 frontiers (the step's token is already written at
    ``lens[b]``).  ``kernel="fused"`` runs the CUDA table walk
    (``kernels/posit_paged_attn.py``; its plain version on the CPU);
    ``kernel="gather"`` is ``paged_gather`` + :func:`decode_attention`.
    """
    from repro_torch.kernels import posit_paged_attn as K

    b, _, h, d = q.shape
    nb, bs, g = k_arena.shape[0], k_arena.shape[1], k_arena.shape[2]
    apos = paged_apos(tables, lens, bs, nb, window=window)
    if kernel == "fused":
        qg = (q.reshape(b, g, h // g, d) * d ** -0.5).to(torch.float32)
        out = K.paged_decode_attention(
            qg.contiguous(), k_arena, v_arena, tables.to(torch.int32).contiguous(),
            apos.contiguous(), lens.to(torch.int32).contiguous(),
            pcfg=pcfg(kv_posit) if kv_posit else None, window=window)
        return out.reshape(b, 1, h, -1).to(q.dtype)
    if kernel != "gather":
        raise ValueError(f"unknown paged decode kernel {kernel!r}")
    return decode_attention(
        q, paged_gather(k_arena, tables), paged_gather(v_arena, tables),
        lens + 1, cfg=cfg, kv_posit=kv_posit, window=window, apos=apos)


def decode_attention_paged_mla(q_lat_eff, q_rope, c_arena, r_arena, tables,
                               lens, *, cfg: ModelConfig,
                               kv_posit: Optional[str] = None,
                               kernel: str = "gather"):
    """Absorbed-matrix MLA paged decode: latent-space attention off the
    block tables; returns the latent context (B, H, rank) f32 (the
    caller applies ``wuv``).

    q_lat_eff (B, H, rank) and q_rope (B, H, rope); arenas
    (n_blocks, bs, rank) and (n_blocks, bs, rope); tables (B, W) int32;
    lens (B,) int32 frontiers (the step's latent is already written).
    ``kernel="fused"`` runs the CUDA latent table walk
    (``kernels/posit_paged_attn.py``; its plain version on the CPU);
    ``kernel="gather"`` is ``paged_gather``, dequantize and a masked
    softmax whose all-masked rows are exact zeros.  MLA has no window.
    """
    from repro_torch.kernels import posit_paged_attn as K

    nb, bs = c_arena.shape[0], c_arena.shape[1]
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    apos = paged_apos(tables, lens, bs, nb)
    if kernel == "fused":
        return K.paged_decode_attention_mla(
            q_lat_eff.to(torch.float32).contiguous(),
            q_rope.to(torch.float32).contiguous(), c_arena, r_arena,
            tables.to(torch.int32).contiguous(), apos.contiguous(),
            lens.to(torch.int32).contiguous(),
            pcfg=pcfg(kv_posit) if kv_posit else None, scale=scale)
    if kernel != "gather":
        raise ValueError(f"unknown paged decode kernel {kernel!r}")
    c = paged_gather(c_arena, tables)                 # (B, W*bs, rank)
    r = paged_gather(r_arena, tables)
    if kv_posit:
        c, r = posit_codec.dequantize_many([c.contiguous(), r.contiguous()],
                                           pcfg(kv_posit))
    c = c.to(torch.float32)
    r = r.to(torch.float32)
    scores = torch.einsum("bhr,btr->bht", q_lat_eff.to(torch.float32), c)
    scores = scores + torch.einsum("bhd,btd->bht",
                                   q_rope.to(torch.float32), r)
    valid = (apos >= 0) & (apos <= lens.to(apos.dtype)[:, None])
    valid = valid[:, None, :]
    scores = torch.where(valid, scores * scale, _NEG)
    m = scores.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    probs = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return torch.einsum("bht,btr->bhr", probs, c)


def paged_write_slots(tables, pos, ok, *, n_blocks: int, block_size: int,
                      window: int = 0):
    """Where each row's one-token write lands, as a dense (B,) int64
    tensor: the flat arena slot ``block * block_size + offset``, or -1
    where the write drops (``ok`` False, or through a sentinel entry).
    No host sync: the fused write (``kernels.posit_codec.paged_write``)
    drops the -1 rows on the device."""
    w = tables.shape[1]
    pos = pos.to(torch.int64)
    blk = torch.div(pos, block_size, rounding_mode="floor")
    if paged_is_window_lane(window, block_size, w):
        slot = torch.fmod(blk, w)
    else:
        slot = blk
        ok = ok & (blk < w)
    phys = tables.to(torch.int64).gather(1, slot.clamp(0, w - 1)[:, None])[:, 0]
    flat = phys * block_size + torch.fmod(pos, block_size)
    return torch.where(ok & (phys < n_blocks), flat, -1)


def paged_write_index(tables, pos, ok, *, n_blocks: int, block_size: int,
                      window: int = 0):
    """Where each row's one-token write lands: ``(rows, blocks, offsets)``
    of the writes that are kept.  Rows with ``ok`` False and writes
    through sentinel entries are dropped, never clamped (one host sync).
    Shared by every layer and by K and V within a decode step."""
    slots = paged_write_slots(tables, pos, ok, n_blocks=n_blocks,
                              block_size=block_size, window=window)
    rows = torch.nonzero(slots >= 0)[:, 0]
    return (rows, torch.div(slots[rows], block_size, rounding_mode="floor"),
            torch.fmod(slots[rows], block_size))


def paged_write(arena, upd, index):
    """Apply a :func:`paged_write_index` to one layer's arena, in place:
    ``arena[blocks, offsets] = upd[rows]``."""
    rows, blocks, offs = index
    signed_view(arena)[blocks, offs] = signed_view(upd)[rows]
    return arena


def paged_cache_update(arena, upd, tables, pos, ok, *, window: int = 0):
    """Write one new KV vector per row into its block, in place: row b
    writes ``upd[b]`` at logical position ``pos[b]``; rows with
    ``ok=False`` and writes through sentinel entries are dropped."""
    index = paged_write_index(tables, pos, ok, n_blocks=arena.shape[0],
                              block_size=arena.shape[1], window=window)
    return paged_write(arena, upd, index)


def paged_pack(arena, kvs, tables, lens, *, window: int = 0,
               src_shift=None, src_ring: bool = False):
    """Pack prompt KV (L, B, S, ...) into whole arena blocks (L, nb, bs,
    ...), in place; returns ``arena``.  Patterns move verbatim.

    Row b's content positions land in the blocks ``tables[b]`` names
    (sentinel entries drop), each block slot taking the position the
    decode attention will read there (``paged_positions`` at the
    frontier ``lens - 1``).  ``src_shift`` (B,) is each row's content
    start in ``kvs`` (``S - lens`` for left-padded batches; default 0);
    ``src_ring`` reads a ring-layout source at ``pos % S``.  Slots whose
    position precedes the prompt or falls out of the window receive
    clamped garbage the masks exclude, as the reference's do."""
    nb, bs = arena.shape[1], arena.shape[2]
    b, s = kvs.shape[1], kvs.shape[2]
    w = tables.shape[1]
    lens = torch.as_tensor(lens, device=kvs.device).to(torch.int64)
    cpos = paged_positions((lens - 1).clamp(min=0), w, bs,
                           window=window).to(torch.int64)         # (B, W*bs)
    if src_ring:
        tpos = torch.fmod(cpos, s)
    elif src_shift is not None:
        tpos = cpos + torch.as_tensor(src_shift, device=kvs.device).to(
            torch.int64)[:, None]
    else:
        tpos = cpos
    tpos = tpos.clamp(0, s - 1).reshape(b * w, bs)
    ids = torch.as_tensor(tables, device=kvs.device).to(torch.int64).reshape(-1)
    keep = torch.nonzero((ids >= 0) & (ids < nb))[:, 0]
    blocks = signed_view(kvs)[:, torch.div(keep, w, rounding_mode="floor")[:, None],
                              tpos[keep]]                         # (L, K, bs, ...)
    signed_view(arena)[:, ids[keep]] = blocks
    return arena


def paged_pack_slots(tables, start, lens, s: int, *, n_blocks: int,
                     block_size: int, window: int = 0):
    """Where suffix position ``start + t`` (t < ``s``) of each row lands,
    as a dense (B, S) int64 tensor: the flat arena slot
    ``block * block_size + offset``, or -1 where the write drops
    (positions outside ``[start, lens)``, past the table, an older ring
    epoch on the window lane, or a sentinel entry).  No host sync."""
    bs = block_size
    w = tables.shape[1]
    dev = tables.device
    lens = lens.to(torch.int64)
    start = torch.as_tensor(start, device=dev).to(torch.int64)
    start = start.expand(lens.shape[0]) if start.ndim == 0 else start
    pos = start[:, None] + torch.arange(s, device=dev)[None, :]   # (B, S)
    live = pos < lens[:, None]
    blk = torch.div(pos, bs, rounding_mode="floor")
    if paged_is_window_lane(window, bs, w):
        pb = torch.div((lens - 1).clamp(min=0), bs, rounding_mode="floor")
        live &= blk >= (pb - w + 1)[:, None]
        slot = torch.fmod(blk, w)
    else:
        live &= blk < w
        slot = blk
    phys = tables.to(torch.int64).gather(1, slot.clamp(0, w - 1))
    live &= phys < n_blocks
    return torch.where(live, phys * bs + torch.fmod(pos, bs), -1)


def paged_pack_range(arena, kvs, tables, start, lens, *, window: int = 0):
    """Write positions ``[start, lens)`` of suffix KV into arena blocks,
    in place, leaving every other slot untouched.

    arena (L, nb, bs, ...); ``kvs`` (L, B, S, ...) with time index ``t``
    at absolute position ``start + t``.  On the window lane only the
    latest ring epoch of each slot is written (the positions the
    frontier ``lens - 1`` still maps); sentinel entries drop.
    """
    nb, bs = arena.shape[1], arena.shape[2]
    slots = paged_pack_slots(tables.to(kvs.device), start, lens, kvs.shape[2],
                             n_blocks=nb, block_size=bs, window=window)
    rows, cols = torch.nonzero(slots >= 0, as_tuple=True)
    flat = slots[rows, cols]
    signed_view(arena)[:, torch.div(flat, bs, rounding_mode="floor"),
                       torch.fmod(flat, bs)] = signed_view(kvs)[:, rows, cols]
    return arena


def paged_copy_blocks(arena, src_ids, dst_ids):
    """Copy whole arena blocks in place, across every layer:
    ``arena[:, dst_ids[i]] = arena[:, src_ids[i]]``.

    The device half of copy-on-write: posit patterns move verbatim.
    ``src_ids``/``dst_ids`` are host lists; a sentinel (out-of-range)
    destination drops its copy, as the reference's ``mode="drop"``
    scatter does, and a sentinel source clamps."""
    nb = arena.shape[1]
    pairs = [(min(max(int(s), 0), nb - 1), int(d))
             for s, d in zip(src_ids, dst_ids) if 0 <= int(d) < nb]
    if not pairs:
        return arena
    idx = torch.tensor(pairs, dtype=torch.int64, device=arena.device)
    view = signed_view(arena)
    view[:, idx[:, 1]] = view[:, idx[:, 0]]
    return arena


def paged_poison_blocks(arena, block_ids):
    """Overwrite whole arena blocks in place with a loud but finite
    poison, across every layer: the posit maxpos pattern for pattern
    leaves, ``-1e30`` for float leaves (NaN would leak through the
    ``0 * poison`` of properly masked slots).  The sanitizer's device
    half: a stale table entry naming a reclaimed block corrupts logits
    visibly.  Sentinel ids drop."""
    nb = arena.shape[1]
    ids = [int(i) for i in block_ids if 0 <= int(i) < nb]
    if not ids:
        return arena
    if arena.dtype in (torch.uint8, torch.uint16, torch.uint32):
        poison = (1 << (8 * arena.element_size() - 1)) - 1      # maxpos
    else:
        poison = -1e30
    signed_view(arena)[:, torch.tensor(ids, device=arena.device)] = poison
    return arena


# ---------------------------------------------------------------------------
# Feed-forward (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig, *, dtype=torch.float32):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": init_dense(gen, d, f, dtype=dtype),
        "wg": init_dense(gen, d, f, dtype=dtype),
        "wo": init_dense(gen, f, d, dtype=dtype),
    }


def _act(gate, cfg: ModelConfig):
    return F.gelu(gate, approximate="tanh") if cfg.act == "gelu" else F.silu(gate)


def mlp(p, x, cfg: ModelConfig, tp=None):
    """The gated MLP; under ``tp`` (where ``d_ff`` splits) this rank's
    columns, ``wo``'s rows, then the all-reduce."""
    gate = dense(p["wg"], x, cfg)
    return dense_row(p["wo"], _act(gate, cfg) * dense(p["wi"], x, cfg), cfg, tp)


# ---------------------------------------------------------------------------
# Mixture of Experts: sort-based capacity dispatch, row-local
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ModelConfig, *, dtype=torch.float32):
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    s = d ** -0.5

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale
        return w.to(dtype)

    return {
        "router": init_dense(gen, d, e, dtype=dtype, scale=s),
        "wi": normal((e, d, f), s),
        "wg": normal((e, d, f), s),
        "wo": normal((e, f, d), f ** -0.5),
    }


def moe_top_k(probs, k: int):
    """``lax.top_k`` over the last axis: the k largest values, the lower
    index first among equal values (a stable descending sort; torch's
    ``topk`` leaves tie order unspecified)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_capacity(s: int, cfg: ModelConfig) -> int:
    return int(max(1, (s * cfg.top_k / cfg.n_experts) * cfg.capacity_factor))


def _moe_dispatch(p, x, cfg: ModelConfig):
    """Route every row of x (B, S, D) into fixed-capacity expert buffers
    (B, E, cap, D), each row on its own: the reference's ``_moe_row``
    over all rows at once.

    Every position of a row takes capacity (pad tokens and a chunk's
    positions past its valid count included): cap comes from S.  Top-k
    of the router softmax, weights renormalised; choices sorted by
    expert (stable), the first ``cap`` of each expert kept, the rest
    sent to the overflow slot ``E * cap`` and dropped.  Returns the
    buffers and ``(order, dest, keep, gate_w)``, each (B, S*k).  No
    host sync: counts are a scatter-add into (B, E)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = dense(p["router"], x, cfg).to(torch.float32)         # (B, S, E)
    gate_w, gate_i = moe_top_k(torch.softmax(logits, dim=-1), k)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp(min=1e-9)

    flat_e = gate_i.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)            # groups by expert
    sorted_e = flat_e.gather(1, order)
    counts = torch.zeros((b, e), dtype=torch.int64, device=x.device).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    offsets = counts.cumsum(1) - counts                           # exclusive
    pos_in_e = torch.arange(s * k, device=x.device)[None, :] - offsets.gather(1, sorted_e)

    cap = _moe_capacity(s, cfg)
    keep = pos_in_e < cap
    dest = torch.where(keep, sorted_e * cap + pos_in_e, e * cap)  # overflow slot

    tok_sorted = torch.div(order, k, rounding_mode="floor")
    xg = x.gather(1, tok_sorted[..., None].expand(b, s * k, d))
    xg = torch.where(keep[..., None], xg, torch.zeros((), dtype=x.dtype, device=x.device))
    slots = e * cap + 1                   # row b's buffer starts at b * slots
    row0 = torch.arange(b, device=x.device)[:, None] * slots
    buf = x.new_zeros((b * slots, d)).index_copy_(
        0, (dest + row0).reshape(-1), xg.reshape(b * s * k, d))
    xe = buf.view(b, slots, d)[:, :-1].reshape(b, e, cap, d)
    return xe, (order, dest, keep, gate_w)


def _moe_combine(ye, aux, cfg: ModelConfig):
    """Expert outputs (B, E, cap, D) back to (B, S, D): each kept choice
    read from its slot (dropped ones are zero), written back through
    ``order``, scaled by its gate weight and summed over the k choices."""
    b, e, cap, d = ye.shape
    order, dest, keep, gate_w = aux
    sk = order.shape[1]
    y_sorted = ye.reshape(b, e * cap, d).gather(
        1, dest.clamp(max=e * cap - 1)[..., None].expand(b, sk, d))
    y_sorted = torch.where(keep[..., None], y_sorted,
                           torch.zeros((), dtype=ye.dtype, device=ye.device))
    y_flat = torch.empty_like(y_sorted).scatter_(
        1, order[..., None].expand(b, sk, d), y_sorted)
    k = cfg.top_k
    return (y_flat.view(b, sk // k, k, d) * gate_w[..., None].to(ye.dtype)).sum(2)


def moe(p, x, cfg: ModelConfig, experts=None):
    """x (B, S, D) -> (B, S, D): row-local top-k dispatch, then every
    expert's SwiGLU/GeGLU on its (B * cap) buffer rows as one batched
    product over the experts, output in the compute dtype.

    ``experts=(first, n)`` (expert-parallel serving): ``p``'s expert
    weights are experts ``first .. first+n-1`` only.  The router, the
    dispatch and the capacity are the whole model's (every rank drops
    the same choices); only these experts run, the others' outputs are
    zero, and the result is this rank's partial sum of the combine."""
    b, s, d = x.shape
    xe, aux = _moe_dispatch(p, x, cfg)                            # (B, E, cap, D)
    e, cap = xe.shape[1], xe.shape[2]
    if experts is not None:
        first, e = experts
        full, xe = xe, xe[:, first:first + e]
    wi, wg, wo = (maybe_dequant(p[key], cfg).to(x.dtype) for key in ("wi", "wg", "wo"))
    xf = xe.transpose(0, 1).reshape(e, b * cap, d)
    h = _act(torch.bmm(xf, wg), cfg) * torch.bmm(xf, wi)         # (E, B*cap, F)
    ye = torch.bmm(h, wo).reshape(e, b, cap, d).transpose(0, 1)   # (B, E, cap, D)
    if experts is not None:
        ye = torch.zeros_like(full).index_copy_(
            1, torch.arange(first, first + e, device=x.device), ye)
    return _moe_combine(ye, aux, cfg)


# ---------------------------------------------------------------------------
# Training: layer rematerialisation and the chunked vocabulary loss
# ---------------------------------------------------------------------------

# the train step's FSDP gather of a layer's parameters (``layer_gather``)
_LAYER_GATHER = contextvars.ContextVar("layer_gather", default=None)


@contextlib.contextmanager
def layer_gather(gather):
    """Within the block, :func:`remat_layer` (and :func:`gathered`)
    pass a layer's parameters through ``gather`` (the FSDP step's whole
    leaves from this rank's pieces) inside the layer, so that under
    ``cfg.remat == "layer"`` the gather reruns in the recompute and the
    whole copies live no longer than the layer's forward."""
    token = _LAYER_GATHER.set(gather)
    try:
        yield
    finally:
        _LAYER_GATHER.reset(token)


def gathered(lp):
    """A layer's parameters through the active :func:`layer_gather`
    (themselves outside one)."""
    gather = _LAYER_GATHER.get()
    return lp if gather is None else gather(lp)


def _run_gathered(fn, gather, lp, *rest):
    return fn(gather(lp), *rest)


def remat_layer(fn, cfg: ModelConfig, lp, *args):
    """``fn(lp, *args)``, ``lp`` a layer's parameters (through the active
    :func:`layer_gather`, inside ``fn``'s recompute); under autograd with
    ``cfg.remat == "layer"`` its activations are recomputed in the
    backward pass instead of kept (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint`` around each scanned layer).  A MoE
    layer recomputes its dispatch too: the reference keeps the MoE
    output (``moe_out``) instead, the same values either way."""
    gather = _LAYER_GATHER.get()
    if gather is not None:
        fn = functools.partial(_run_gathered, fn, gather)
    if cfg.remat == "layer" and torch.is_grad_enabled():
        return checkpoint(fn, lp, *args, use_reentrant=False)
    return fn(lp, *args)


def next_token_labels(tokens):
    """(B, S) labels: each position's next token, 0 at the last, and
    the (B, S) f32 label mask with the last position off."""
    b, s = tokens.shape
    labels = torch.cat([tokens[:, 1:], tokens.new_zeros((b, 1))], dim=1)
    mask = torch.ones((b, s), dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    return labels, mask


def chunked_xent(x, w, labels, mask, loss_chunk: int, *, denom=None, tp=None):
    """Mean next-token cross entropy over the unmasked positions, the
    vocabulary projection ``x @ w`` run ``loss_chunk`` positions at a
    time to bound the (B, chunk, V) f32 logits: the reference's
    ``chunk_loss`` under ``lax.map``, the chunks' sums added in order.
    As there, positions past the last whole chunk are left out.

    ``denom`` (data parallelism) divides the sum instead of this call's
    own label count: the count of the whole batch that this call's rows
    are part of (:func:`xent_count`).  Under a tensor-parallel plan
    ``tp`` whose vocabulary splits, ``w`` holds this rank's columns and
    the loss is vocabulary-parallel: each chunk's maximum, sum of
    exponentials and gold logit are all-reduced, and ``x`` enters the
    column-parallel head through ``tp.enter``.

    Under the sequence layout (``tp.seq``) ``x`` holds this rank's
    positions and ``labels``/``mask`` the whole sequence's.  Where the
    vocabulary splits, the head takes the whole sequence
    (``tp.seq_gather``) and the loss stays vocabulary-parallel; where it
    does not, each rank's loss covers its own positions (those of whole
    chunks of the whole sequence, in chunks that divide its share) and
    the sums are added over the group (``tp.reduce``)."""
    labels = labels.to(torch.int64)
    seq = tp is not None and tp.seq
    vocab_parallel = tp is not None and tp.vocab
    if seq and vocab_parallel:
        x = tp.seq_gather(x)
    elif vocab_parallel:
        x = tp.enter(x)
    s = x.shape[1]
    ck = min(loss_chunk, s)
    if seq and not vocab_parallel:
        whole = labels.shape[1]
        p0, own = tp.positions(whole)
        ck = min(loss_chunk, whole)
        kept = torch.arange(p0, p0 + own, device=mask.device) < (whole // ck) * ck
        labels, mask = labels[:, p0:p0 + own], mask[:, p0:p0 + own] * kept
        ck = _pick_chunk(own, ck)
    if vocab_parallel:
        v0, n = tp._vocab_slice()
    losses, counts = [], []
    for c0 in range(0, (s // ck) * ck, ck):
        logits = (x[:, c0:c0 + ck] @ w).to(torch.float32)
        lab = labels[:, c0:c0 + ck]
        if vocab_parallel:
            m = tp.max(logits.amax(-1))
            logz = m + torch.log(tp.reduce(torch.exp(logits - m[..., None]).sum(-1)))
            local = lab - v0
            inside = (local >= 0) & (local < n)
            gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
            gold = tp.reduce(torch.where(inside, gold, torch.zeros_like(gold)))
        else:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        ms = mask[:, c0:c0 + ck]
        losses.append(((logz - gold) * ms).sum())
        counts.append(ms.sum())
    total = torch.stack(losses).sum()
    if seq and not vocab_parallel:
        total = tp.reduce(total, what="loss")
        if denom is None:
            denom = torch.clamp(tp.all_reduce(torch.stack(counts).sum(), what="loss"), min=1.0)
    if denom is None:
        denom = torch.clamp(torch.stack(counts).sum(), min=1.0)
    return total / denom


def xent_count(mask, loss_chunk: int):
    """The denominator :func:`chunked_xent` takes for ``mask``: its
    labels in whole chunks, at least one."""
    s = mask.shape[1]
    ck = min(loss_chunk, s)
    return torch.clamp(mask[:, :(s // ck) * ck].sum(), min=1.0)
