"""Posit wire-format gradient reductions (the posit-domain consumers).

Gradients cross the wire as posit16/posit8 patterns; the reductions a
hierarchical cross-pod sync runs on them -- ``combine_compressed``,
``scale_compressed``, ``mean_compressed`` -- stay in the posit domain
on the fused elementwise kernel (``kernels.ops``), one rounding per op
and no f32 round trip, as ``repro/compress/gradient.py`` does.  Trees
are nested dicts, lists and tuples of tensors.

Error-feedback compression (``compress_with_feedback``) belongs to the
training loop and is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core import softposit_ref
from repro_torch.core.convert import posit_to_f32
from repro_torch.core.types import POSIT8, POSIT16, PositConfig, to_storage
from repro_torch.kernels import ops as kops

_CFGS = {"posit16": POSIT16, "posit8": POSIT8}


def pcfg_of(name: str) -> PositConfig:
    return _CFGS[name]


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of equally shaped nested containers."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def decompress(patterns, name: str):
    cfg = pcfg_of(name)
    return tree_map(lambda q: posit_to_f32(q, cfg), patterns)


def scalar_pattern(value: float, cfg: PositConfig, device=None) -> torch.Tensor:
    """A Python scalar as a 0-d posit pattern (exact RNE)."""
    p = torch.tensor(softposit_ref.from_float(float(value), cfg),
                     dtype=torch.int64, device=device)
    return to_storage(p, cfg.storage_dtype)


def combine_compressed(qa, qb, name: str):
    """Elementwise posit add of two wire-format trees, one rounding per
    element (the dequantize -> f32 add -> requantize it replaces rounds
    twice)."""
    cfg = pcfg_of(name)
    return tree_map(lambda a, b: kops.vadd(a, b, cfg), qa, qb)


def scale_compressed(q, scale: float, name: str):
    """Scale a wire-format tree by a scalar in the posit domain."""
    cfg = pcfg_of(name)
    return tree_map(
        lambda p: kops.vmul(p, scalar_pattern(scale, cfg, p.device), cfg), q)


def mean_compressed(q_tiled, name: str):
    """Mean over the leading (pod) axis in wire format: a balanced
    pairwise vadd tree, then one exact divide by the pod count (a pure
    exponent shift for a power-of-two count)."""
    cfg = pcfg_of(name)

    def one(q):
        parts = [q[i] for i in range(q.shape[0])]
        while len(parts) > 1:
            nxt = [kops.vadd(parts[i], parts[i + 1], cfg)
                   for i in range(0, len(parts) - 1, 2)]
            if len(parts) % 2:
                nxt.append(parts[-1])
            parts = nxt
        count = scalar_pattern(float(q.shape[0]), cfg, q.device)
        return kops.vdiv(parts[0], count, cfg, mode="exact")

    return tree_map(one, q_tiled)
