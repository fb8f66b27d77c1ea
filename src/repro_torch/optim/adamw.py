"""AdamW with global-norm clipping and optional posit16 moment storage.

The port of ``repro/optim/adamw.py``.  Posit moment storage is the
paper's technique applied to optimizer memory: with
``posit_moments`` the first moment lives as posit16 patterns (half the
bytes of f32), quantized by ``csrc/posit_codec.cu``'s quantize after
every update and at init, and decoded by its dequantize before every
update (``kernels.posit_codec``: the kernels on a CUDA tensor, their
plain versions on a CPU tensor).

The update runs leaf by leaf under ``torch.no_grad()`` and writes the
parameters and ``v`` in place (the reference returns new arrays); each
leaf's arithmetic is the reference's, operation for operation, in f32.
Its transients are at most three f32 copies of the leaf being updated.

Under tensor parallelism (``tp``, with ``split`` naming the leaves that
``"model"`` splits) the gradient norm sums a split leaf's squares over
the group and counts a replicated leaf once (hymba's ``in_proj``
segment by segment), so the clip scale is the single device's; every
other step of the update is leaf-local.  Under FSDP (``shards``) the
parameters, gradients, ``m`` and ``v`` are a rank's pieces of the leaves
that ``"data"`` splits: the norm sums their squares over ``"data"`` as
well, and the update is elementwise on the piece.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import tree as T
from repro_torch.core.types import POSIT16
from repro_torch.kernels import posit_codec

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    posit_moments: bool = False   # store m in posit16 (paper technique)


def quantize_m(x):
    """f32 first moment -> posit16 patterns (row 1 on the card)."""
    return posit_codec.quantize(x.contiguous(), POSIT16)


def dequantize_m(p):
    """posit16 first moment -> f32 (row 2 on the card)."""
    return posit_codec.dequantize(p.contiguous(), POSIT16)


def init(params, cfg: AdamWConfig):
    """Zero moments on each parameter's device; ``m`` quantized (one
    quantize a leaf) under ``posit_moments``."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=_F32, device=p.device)

    m = T.tree_map(lambda p: quantize_m(zeros(p)) if cfg.posit_moments
                   else zeros(p), params)
    v = T.tree_map(zeros, params)
    dev = T.leaves(params)[0].device
    return {"m": m, "v": v, "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, tp=None, split=None, shards=None):
    """sqrt of the sum of every leaf's sum of squares, summed in leaf
    order (the port's order, not ``jax.tree``'s: equal to rounding).
    Under ``tp``, the squares of the leaves that ``split`` marks
    (``sharding.split_leaves``) are summed over the ``"model"`` group;
    the replicated ones count once, and so do the whole segments of a
    leaf marked ``(dim, Segments)``, whose split segments sum.  Under
    FSDP (``shards``, ``collectives.DataShards``) the squares of the
    pieces that ``"data"`` splits are summed over ``"data"`` too."""
    if tp is None and shards is None:
        total = 0.0
        for x in T.leaves(tree):
            total = total + torch.sum(torch.square(x.to(_F32)))
        return torch.sqrt(total)
    leaves = T.leaves(tree)
    split = split or [False] * len(leaves)
    dims = shards.dims if shards is not None else [None] * len(leaves)
    parts = {}          # (split over "model", over "data") -> the sum of squares
    for x, s, d in zip(leaves, split, dims):
        pieces = s[1].pieces(x, s[0], tp.size) if isinstance(s, tuple) else [(x, s)]
        for piece, sp in pieces:
            key = (bool(sp), d is not None)
            parts[key] = parts.get(key, 0.0) + torch.sum(torch.square(piece.to(_F32)))
    dev = leaves[0].device

    def local(key):
        return torch.as_tensor(parts.get(key, 0.0), dtype=_F32, device=dev)
    if shards is None:
        return torch.sqrt(local((False, False)) + tp.all_reduce(local((True, False)),
                                                                 what="norm"))
    by_data = shards.all_reduce(torch.stack([local((False, True)), local((True, True))]))
    by_model = torch.stack([local((True, False)), by_data[1]])
    if tp is not None:
        by_model = tp.all_reduce(by_model, what="norm")
    return torch.sqrt(local((False, False)) + by_data[0] + by_model.sum())


@dataclasses.dataclass(frozen=True)
class Coefficients:
    """The step's scalars, shared by every leaf (0-d f32 tensors on the
    parameters' device, ``count`` int32)."""
    count: torch.Tensor
    grad_norm: torch.Tensor
    scale: torch.Tensor
    bc1: torch.Tensor
    bc2: torch.Tensor
    lr: object


@torch.no_grad()
def coefficients(grads, state, cfg: AdamWConfig,
                 lr_scale: Optional[torch.Tensor] = None, *, tp=None,
                 split=None, shards=None) -> Coefficients:
    count = state["count"] + 1
    gnorm = global_norm(grads, tp, split, shards)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    cf = count.to(_F32)
    bc1 = 1 - torch.pow(cfg.b1, cf)
    bc2 = 1 - torch.pow(cfg.b2, cf)
    lr = cfg.lr * (lr_scale if lr_scale is not None else 1.0)
    return Coefficients(count, gnorm, scale, bc1, bc2, lr)


@torch.no_grad()
def update_leaf(p, g, m, v, c: Coefficients, cfg: AdamWConfig):
    """One leaf's AdamW step: ``p`` and ``v`` in place, returns the new
    ``m`` (posit16 patterns under ``posit_moments``, else ``m`` itself,
    updated in place)."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.to(_F32) * c.scale
    m_new = dequantize_m(m) if cfg.posit_moments else m
    m_new.mul_(b1).add_(g * (1 - b1))                 # b1 * m + (1 - b1) * g
    v.mul_(b2).add_((g * (1 - b2)).mul_(g))           # b2 * v + (1 - b2) * g * g
    del g
    if cfg.posit_moments:
        m_out = quantize_m(m_new)
        mhat = m_new.div_(c.bc1)
    else:
        m_out = m_new
        mhat = m_new / c.bc1
    denom = (v / c.bc2).sqrt_().add_(cfg.eps)
    step = mhat.div_(denom)
    del denom
    p32 = p if p.dtype == _F32 else p.to(_F32)
    p32.mul_(1 - c.lr * cfg.weight_decay).sub_(step.mul_(c.lr))
    if p32 is not p:
        p.copy_(p32)
    return m_out


@torch.no_grad()
def update(grads, state, params, cfg: AdamWConfig,
           lr_scale: Optional[torch.Tensor] = None, *, tp=None, split=None,
           shards=None):
    """Returns ``(params, new_state, {"grad_norm": ...})``; the
    parameters and ``state["v"]`` are updated in place.  ``tp``,
    ``split`` and ``shards``: :func:`global_norm` under tensor
    parallelism and FSDP (each leaf a rank's piece, updated as it is)."""
    c = coefficients(grads, state, cfg, lr_scale, tp=tp, split=split, shards=shards)
    new_m = [update_leaf(p, g, m, v, c, cfg) for p, g, m, v in zip(
        T.leaves(params), T.leaves(grads), T.leaves(state["m"]), T.leaves(state["v"]))]
    new_state = {"m": T.unflatten(state["m"], new_m), "v": state["v"], "count": c.count}
    return params, new_state, {"grad_norm": c.grad_norm}


def cosine_schedule(step, *, base_lr=1.0, warmup=100, total=10000,
                    min_frac=0.1, device=None):
    """Linear warm-up then cosine decay to ``min_frac``; ``step`` an int
    or a tensor, the result a 0-d f32 tensor."""
    step = torch.as_tensor(step, device=device).to(_F32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos
