"""Fused paged-decode attention (CUDA), posit K/V decoded in-kernel.

Replaces ``repro/kernels/posit_paged_attn.py``'s two Pallas TPU kernels:
``paged_decode_attention`` (``_paged_attn_kernel``, the dense/GQA and
sliding-window lanes) and ``paged_decode_attention_mla``
(``_paged_attn_mla_kernel``, the MLA lane).  The TPU kernels walk each
row's block table as a sequential grid axis with the online-softmax
state in VMEM.  On the H100:

- ``csrc/paged_attn.cu`` (dense and window lanes).  Bound: memory --
  the K/V patterns of each row's live blocks, read once
  (:func:`paged_decode_kv_bytes` per layer), a few tens of MB per call
  at decode batch sizes, so the whole card has to read at once.  The
  table is split over the grid (flash-decoding): one CTA per (row, KV
  head, head group, run of :func:`split_chunk` table entries), which
  skips sentinel entries without loading them, keeps the next block's
  patterns in flight with ``cp.async`` while it decodes the current one
  (16-byte vectors, once per block for all query heads) and scores it
  with whole warps: a lane per slot, each score one FMA chain over D in
  the order of the plain version's f32 einsum, then lanes span Dv for
  P.V.  A second kernel folds the runs' partial softmax states in
  split order.
- ``csrc/paged_attn_mla.cu`` (MLA lane).  Bound: fp32 operations (some
  75 flops per latent byte at minicpm3-4b's widths), a few microseconds
  at decode batch sizes, so parallelism and latency are what matter.
  The same split as the dense lane with all H query heads in the CTA:
  one CTA per (row, run of :func:`split_chunk_mla` table entries), so a
  live latent block is loaded (``cp.async``, prefetched) and decoded
  once per row; a thread per (slot, head pair) scores, a group of lanes
  per head runs the softmax step, a thread per (4 latent columns, 8
  heads) does P.V.  fp32 FMAs, no tensor cores.  The runs' partial states fold in
  split order with the dense lane's fold (``csrc/paged_split.cuh``).

Masking contract (shared with ``models/layers.py::paged_apos``): a slot
counts iff ``0 <= apos < lens + 1``, it is inside the window when one is
set, and its table entry is not the sentinel ``nb``.  Invalid slots get
``p = 0``, so a row with no valid slot returns exact zeros.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.core.convert import posit_to_f32
from repro_torch.core.types import PositConfig, index_rows

from . import _build

_NEG = -1e30

launches = {"paged_decode_attention": 0, "paged_decode_attention_mla": 0}

_KV_KIND = {torch.float32: 0, torch.bfloat16: 1}


def _decode_block(x: torch.Tensor, pcfg: Optional[PositConfig]):
    if pcfg is None:
        return x.to(torch.float32)
    return posit_to_f32(x, pcfg)


def _kv_kind(dtype: torch.dtype, pcfg: Optional[PositConfig], who: str) -> int:
    """The kernels' ``kv_kind`` code for an arena dtype (0 f32, 1 bf16,
    2 posit16, 3 posit8); raises on storage they do not take."""
    if pcfg is None:
        kind = _KV_KIND.get(dtype)
    elif (pcfg.nbits, pcfg.es) in ((16, 2), (8, 2)) \
            and dtype == pcfg.storage_dtype:
        kind = 2 if pcfg.nbits == 16 else 3
    else:
        kind = None
    if kind is None:
        raise ValueError(f"{who}: unsupported KV storage {dtype} for "
                         f"pcfg={pcfg}")
    return kind


def _check_args(who: str, device, expect: dict) -> None:
    """Raise unless every ``name: (tensor, shape, dtype)`` is a
    contiguous tensor of that shape and dtype on ``device``."""
    for name, (t, shape, dtype) in expect.items():
        if t.device != device or tuple(t.shape) != shape \
                or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{who}: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")


def paged_decode_partial_plain(q, k_arena, v_arena, tables, apos, lens, *,
                               pcfg: Optional[PositConfig] = None,
                               window: int = 0):
    """The table walk's online-softmax state before normalising: running
    max ``m`` and denominator ``l`` (B, G, R) and accumulator ``acc``
    (B, G, R, Dv), all f32, vectorized over rows.  A row with no valid
    slot keeps ``l == 0`` and ``acc == 0``."""
    b, g, r, d = q.shape
    nb, bs = k_arena.shape[0], k_arena.shape[1]
    w = tables.shape[1]
    dv = v_arena.shape[-1]
    q = q.to(torch.float32)
    m = torch.full((b, g, r), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, g, r), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, g, r, dv), dtype=torch.float32, device=q.device)
    cl = (lens.to(torch.int64) + 1)[:, None]
    apos = apos.reshape(b, w, bs).to(torch.int64)
    for wi in range(w):
        tab = tables[:, wi].to(torch.int64)
        blk = tab.clamp(0, nb - 1)
        k = _decode_block(index_rows(k_arena, blk), pcfg)   # (B, bs, G, D)
        v = _decode_block(index_rows(v_arena, blk), pcfg)   # (B, bs, G, Dv)
        s = torch.einsum("bgrd,btgd->bgrt", q, k)
        a = apos[:, wi]
        valid = (a >= 0) & (a < cl)
        if window:
            valid &= a >= cl - window
        valid &= (tab < nb)[:, None]
        valid = valid[:, None, None, :]
        s = torch.where(valid, s, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrt,btgv->bgrv", p, v)
        m = m_new
    return m, l, acc


def paged_decode_attention_plain(q, k_arena, v_arena, tables, apos, lens, *,
                                 pcfg: Optional[PositConfig] = None,
                                 window: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the whole table walked in
    one online softmax, vectorized over rows."""
    _, l, acc = paged_decode_partial_plain(q, k_arena, v_arena, tables, apos,
                                           lens, pcfg=pcfg, window=window)
    return acc / torch.clamp(l, min=1e-30)[..., None]


def fold_partials_plain(m, l, acc) -> torch.Tensor:
    """Plain version of the split fold: ``m``, ``l`` (..., S) and ``acc``
    (..., S, Dv) of S splits -> (..., Dv).  Splits with ``l == 0`` weigh
    nothing, the others ``exp(m_s - max m)``; summed in split order."""
    live = l > 0
    mx = torch.where(live, m, _NEG).amax(-1, keepdim=True)
    wgt = torch.where(live, torch.exp(m - mx), 0.0)
    lsum = torch.zeros_like(l[..., 0])
    asum = torch.zeros_like(acc[..., 0, :])
    for s in range(l.shape[-1]):
        lsum = lsum + l[..., s] * wgt[..., s]
        asum = asum + acc[..., s, :] * wgt[..., s, None]
    return asum / torch.clamp(lsum, min=1e-30)[..., None]


# Split CTAs the wrapper aims the grid at, per SM: 1 056 on the H100's
# 132.  At phi3's D 128, bs 16, posit16 a CTA (128 threads) takes some
# 35 KB of shared memory, so 6 are resident per SM at once and the
# first wave ends as the splits with few live blocks drain.
_CTAS_PER_SM = 8
_MAX_CHUNK = 32


def split_chunk(w: int, rows: int, sms: int) -> int:
    """Table entries per split CTA: the power of two nearest the entries
    one CTA would walk if the ``w * rows`` entries of ``rows`` (row, KV
    head) pairs were spread over ``_CTAS_PER_SM * sms`` CTAs, in [1,
    min(w, 32)].  Phi3's decode case (B 8 x G 10, W 64) on 132 SMs gets
    4, so 16 splits and 1 280 CTAs; a short table gets 1."""
    return _chunk_for(w, rows, _CTAS_PER_SM * sms)


def _chunk_for(w: int, rows: int, ctas: int) -> int:
    """The power of two nearest ``w * rows / ctas``, in [1, min(w, 32)]."""
    per = w * rows / ctas
    c = 1 if per < 1 else 1 << round(math.log2(per))
    return max(1, min(c, _MAX_CHUNK, w))


def _prepare(q, k_arena, v_arena, tables, apos, lens, pcfg, window,
             chunk=None):
    """Checks, output and scratch of one launch; returns ``(call, out)``
    with ``call()`` the launch's C call (returns its CUDA error code)."""
    b, g, r, d = q.shape
    nb, bs = k_arena.shape[0], k_arena.shape[1]
    w = tables.shape[1]
    dv = v_arena.shape[-1]
    kind = _kv_kind(k_arena.dtype, pcfg, "paged_decode_attention")
    _check_args("paged_decode_attention", q.device, {
        "q": (q, (b, g, r, d), torch.float32),
        "k_arena": (k_arena, (nb, bs, g, d), k_arena.dtype),
        "v_arena": (v_arena, (nb, bs, g, dv), k_arena.dtype),
        "tables": (tables, (b, w), torch.int32),
        "apos": (apos, (b, w * bs), torch.int32),
        "lens": (lens, (b,), torch.int32),
    })
    if d > 256 or dv > 256:
        raise ValueError(f"paged_decode_attention: D={d}, Dv={dv}; the "
                         "kernel holds at most 256 per lane group")
    out = torch.empty((b, g, r, dv), dtype=torch.float32, device=q.device)
    if w == 0 or b * g * r == 0:
        out.zero_()                         # no slot: every row is zeros
        return (lambda: 0), out
    c = chunk or split_chunk(w, b * g, _build.sm_count(q.device))
    n_split = -(-w // c)
    scratch = out if n_split == 1 else torch.empty(
        b * g * r * n_split * (dv + 2), dtype=torch.float32, device=q.device)
    lib = _build.load("paged_attn")
    fn = lib.paged_decode_attention
    args = (kind, q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
            tables.data_ptr(), apos.data_ptr(), lens.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), b, g, r, d, dv, nb, bs, w,
            int(window), c, torch.cuda.current_stream(q.device).cuda_stream)
    return (lambda: fn(*args)), out


def paged_decode_attention(q, k_arena, v_arena, tables, apos, lens, *,
                           pcfg: Optional[PositConfig] = None,
                           window: int = 0) -> torch.Tensor:
    """Fused paged decode attention.

    q: (B, G, R, D) f32 pre-scaled by ``D**-0.5``; arenas (nb, bs, G, D)
    and (nb, bs, G, Dv), posit patterns when ``pcfg`` is set, else f32 or
    bf16; tables (B, W) int32 (sentinel ``nb``); apos (B, W*bs) int32
    (``-1`` = dead slot); lens (B,) int32.  D and Dv at most 256.
    Returns (B, G, R, Dv) f32.

    On a CUDA tensor: one call of ``csrc/paged_attn.cu``.  The table is
    split into S = ceil(W / c) runs of c entries (:func:`split_chunk`);
    the CTA of (row, KV head, head group, split) walks its run and
    leaves its f32 state in a scratch tensor from ``torch.empty``,
    (B*G*R, S, Dv) accumulators then (B*G*R, S, 2) pairs (m, l).  The
    fold kernel then combines each head's S partials in split order
    (0, 1, ..., S-1; deterministic), weighting split s by
    ``exp(m_s - max m)`` and a split with ``l == 0`` by 0, and writes
    ``acc / max(l, 1e-30)``.  With S == 1 the split CTA writes the
    output and no scratch or fold is used.  Counted as one launch.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_arena, v_arena, tables, apos, lens, pcfg=pcfg, window=window)
    call, out = _prepare(q, k_arena, v_arena, tables, apos, lens, pcfg, window)
    _build.check(call(), "paged_decode_attention")
    launches["paged_decode_attention"] += 1
    return out


def paged_decode_attention_call(q, k_arena, v_arena, tables, apos, lens, *,
                                pcfg: Optional[PositConfig] = None,
                                window: int = 0, chunk: Optional[int] = None):
    """For timing the kernel alone: ``(call, out)``, where ``call()``
    launches the split and fold kernels once more on the same
    preallocated output and scratch and returns the CUDA error code.
    Not counted in ``launches``; CUDA tensors only.  ``chunk`` overrides
    :func:`split_chunk`."""
    return _prepare(q, k_arena, v_arena, tables, apos, lens, pcfg, window,
                    chunk)


def paged_decode_partial_mla_plain(q_lat, q_rope, c_arena, r_arena, tables,
                                   apos, lens, *,
                                   pcfg: Optional[PositConfig] = None,
                                   scale: float = 1.0):
    """The MLA table walk's online-softmax state before normalising:
    running max ``m`` and denominator ``l`` (B, H) and latent accumulator
    ``acc`` (B, H, rank), all f32, vectorized over rows and heads.  A row
    with no valid slot keeps ``l == 0`` and ``acc == 0``."""
    b, h, rank = q_lat.shape
    nb, bs = c_arena.shape[0], c_arena.shape[1]
    w = tables.shape[1]
    q_lat = q_lat.to(torch.float32)
    q_rope = q_rope.to(torch.float32)
    m = torch.full((b, h), _NEG, dtype=torch.float32, device=q_lat.device)
    l = torch.zeros((b, h), dtype=torch.float32, device=q_lat.device)
    acc = torch.zeros((b, h, rank), dtype=torch.float32, device=q_lat.device)
    cl = (lens.to(torch.int64) + 1)[:, None]
    apos = apos.reshape(b, w, bs).to(torch.int64)
    for wi in range(w):
        tab = tables[:, wi].to(torch.int64)
        blk = tab.clamp(0, nb - 1)
        c = _decode_block(index_rows(c_arena, blk), pcfg)   # (B, bs, rank)
        r = _decode_block(index_rows(r_arena, blk), pcfg)   # (B, bs, rope)
        s = (torch.einsum("bhr,btr->bht", q_lat, c) +
             torch.einsum("bhd,btd->bht", q_rope, r)) * scale
        a = apos[:, wi]
        valid = (a >= 0) & (a < cl) & (tab < nb)[:, None]
        valid = valid[:, None, :]
        s = torch.where(valid, s, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bht,btr->bhr", p, c)
        m = m_new
    return m, l, acc


def paged_decode_attention_mla_plain(q_lat, q_rope, c_arena, r_arena, tables,
                                     apos, lens, *,
                                     pcfg: Optional[PositConfig] = None,
                                     scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of the MLA kernel: the same table walk and
    online softmax in latent space, vectorized over rows and heads."""
    _, l, acc = paged_decode_partial_mla_plain(
        q_lat, q_rope, c_arena, r_arena, tables, apos, lens, pcfg=pcfg,
        scale=scale)
    return acc / torch.clamp(l, min=1e-30)[..., None]


# Split CTAs the MLA wrapper aims the grid at, per SM: one wave on the
# H100's 132.  A CTA holds all H heads (320 threads of 128 registers and
# 86.8 KB of shared memory at minicpm3-4b, posit16), so one is resident
# per SM; a second wave would cost a second CTA prologue and fewer
# entries per split a longer fold.
_MLA_CTAS_PER_SM = 1


def split_chunk_mla(w: int, rows: int, sms: int) -> int:
    """Table entries per MLA split CTA: the power of two nearest the
    entries one CTA would walk if the ``w * rows`` entries were spread
    over ``_MLA_CTAS_PER_SM * sms`` CTAs, in [1, min(w, 32)].
    Minicpm3's decode case (B 8, W 64) on 132 SMs gets 4: 16 splits,
    128 CTAs, partials of 8 x 40 x 16 x 258 floats (5.3 MB, in L2)."""
    return _chunk_for(w, rows, _MLA_CTAS_PER_SM * sms)


@functools.lru_cache(maxsize=None)
def _mla_smem(kind: int, h: int, rank: int, rope: int, bs: int) -> int:
    """Shared memory of one MLA split CTA in bytes, computed by the
    library once per shape; raises for shapes the kernel does not take
    (over the card's 227 KB, or over 512 threads)."""
    smem = _build.load("paged_attn_mla").paged_attn_mla_smem_bytes(
        kind, h, rank, rope, bs)
    if smem < 0:
        raise ValueError(
            f"paged_decode_attention_mla: H={h} rank={rank} rope={rope} "
            f"bs={bs} needs more than the kernel's 227 KB of shared memory "
            "or 512 threads (32 * ceil(ceil(rank/4) * ceil(H/8) / 32))")
    return smem


def _prepare_mla(q_lat, q_rope, c_arena, r_arena, tables, apos, lens, pcfg,
                 scale, chunk=None):
    """Checks, output and scratch of one MLA launch; returns ``(call,
    out)`` with ``call()`` the launch's C call (its CUDA error code)."""
    b, h, rank = q_lat.shape
    rope = q_rope.shape[-1]
    nb, bs = c_arena.shape[0], c_arena.shape[1]
    w = tables.shape[1]
    kind = _kv_kind(c_arena.dtype, pcfg, "paged_decode_attention_mla")
    _check_args("paged_decode_attention_mla", q_lat.device, {
        "q_lat": (q_lat, (b, h, rank), torch.float32),
        "q_rope": (q_rope, (b, h, rope), torch.float32),
        "c_arena": (c_arena, (nb, bs, rank), c_arena.dtype),
        "r_arena": (r_arena, (nb, bs, rope), c_arena.dtype),
        "tables": (tables, (b, w), torch.int32),
        "apos": (apos, (b, w * bs), torch.int32),
        "lens": (lens, (b,), torch.int32),
    })
    out = torch.empty((b, h, rank), dtype=torch.float32, device=q_lat.device)
    if w == 0 or b * h == 0:
        out.zero_()                         # no slot: every row is zeros
        return (lambda: 0), out
    _mla_smem(kind, h, rank, rope, bs)
    c = chunk or split_chunk_mla(w, b, _build.sm_count(q_lat.device))
    n_split = -(-w // c)
    scratch = out if n_split == 1 else torch.empty(
        b * h * n_split * (rank + 2), dtype=torch.float32, device=q_lat.device)
    fn = _build.load("paged_attn_mla").paged_decode_attention_mla
    args = (kind, q_lat.data_ptr(), q_rope.data_ptr(), c_arena.data_ptr(),
            r_arena.data_ptr(), tables.data_ptr(), apos.data_ptr(),
            lens.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, h, rank,
            rope, nb, bs, w, c, float(scale),
            torch.cuda.current_stream(q_lat.device).cuda_stream)
    return (lambda: fn(*args)), out


def paged_decode_attention_mla(q_lat, q_rope, c_arena, r_arena, tables, apos,
                               lens, *, pcfg: Optional[PositConfig] = None,
                               scale: float = 1.0) -> torch.Tensor:
    """Fused paged MLA decode: latent-space scores and context straight
    off the block tables.

    q_lat: (B, H, rank) f32 absorbed query; q_rope: (B, H, rope) f32;
    arenas (nb, bs, rank) and (nb, bs, rope), posit patterns when
    ``pcfg`` is set, else f32 or bf16; tables (B, W) int32 (sentinel
    ``nb``); apos (B, W*bs) int32 (``-1`` = dead slot); lens (B,) int32.
    ``scale`` multiplies the summed scores.  Returns the latent context
    (B, H, rank) f32; the caller applies ``wuv``.

    On a CUDA tensor: one call of ``csrc/paged_attn_mla.cu``.  The table
    is split into S = ceil(W / c) runs of c entries
    (:func:`split_chunk_mla`); the CTA of (row, split) walks its run for
    all H heads and leaves its f32 state in a scratch tensor from
    ``torch.empty``, (B*H, S, rank) accumulators then (B*H, S, 2) pairs
    (m, l), folded in split order as the dense lane's are.  With S == 1
    no scratch or fold is used.  Counted as one launch.
    """
    if q_lat.device.type == "cpu":
        return paged_decode_attention_mla_plain(
            q_lat, q_rope, c_arena, r_arena, tables, apos, lens, pcfg=pcfg,
            scale=scale)
    call, out = _prepare_mla(q_lat, q_rope, c_arena, r_arena, tables, apos,
                             lens, pcfg, scale)
    _build.check(call(), "paged_decode_attention_mla")
    launches["paged_decode_attention_mla"] += 1
    return out


def paged_decode_attention_mla_call(q_lat, q_rope, c_arena, r_arena, tables,
                                    apos, lens, *,
                                    pcfg: Optional[PositConfig] = None,
                                    scale: float = 1.0,
                                    chunk: Optional[int] = None):
    """For timing the MLA kernel alone: ``(call, out)``, where ``call()``
    launches the split and fold kernels once more on the same
    preallocated output and scratch and returns the CUDA error code.
    Not counted in ``launches``; CUDA tensors only.  ``chunk`` overrides
    :func:`split_chunk_mla`."""
    return _prepare_mla(q_lat, q_rope, c_arena, r_arena, tables, apos, lens,
                        pcfg, scale, chunk)


# ---------------------------------------------------------------------------
# Analytic decode-bytes ledger
# ---------------------------------------------------------------------------

_KV_ITEMSIZE = {None: 4, "posit16": 2, "posit8": 1}


def paged_decode_kv_bytes(cfg, table_width: int, block_size: int,
                          kernel: str = "fused") -> int:
    """Device-memory bytes of KV traffic one decode step moves per batch
    row, summed over layers.  The fused kernel reads each row's arena
    blocks once, as stored patterns; the gather path reads the arena,
    writes and reads the gathered copy, and for posit KV writes and
    reads the dequantized compute-dtype cache on top.  q/out and the
    scores are excluded from both sides."""
    itemsize = _KV_ITEMSIZE[cfg.kv_posit]
    slots = table_width * block_size
    if cfg.mla:
        kv_elems = slots * (cfg.kv_lora_rank + cfg.qk_rope_dim)
    else:
        kv_elems = slots * cfg.n_kv_heads * 2 * cfg.head_dim
    pattern_bytes = kv_elems * itemsize
    if kernel == "fused":
        per_layer = pattern_bytes
    elif kernel == "gather":
        per_layer = 3 * pattern_bytes
        if cfg.kv_posit is not None:
            cbytes = 2 if cfg.compute_dtype == "bfloat16" else 4
            per_layer += 2 * kv_elems * cbytes
    else:
        raise ValueError(f"unknown paged decode kernel {kernel!r}")
    return per_layer * cfg.n_layers
