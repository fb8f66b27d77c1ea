"""Posit gradient compression: error feedback and wire-format reductions.

Error-feedback compression (EF-SGD / EF21 style), as
``repro/compress/gradient.py``:

    buf    <- g + e                  (accumulate the residual)
    q      <- posit_quantize(buf)    (what crosses the wire)
    e'     <- buf - dequantize(q)    (the residual stays local)

``compress_with_feedback`` runs the codec kernels on the card
(``kernels.posit_codec``: a quantize and a dequantize a leaf), their
plain versions on the CPU; so does ``decompress`` (one dequantize a
leaf, a pod-stacked ``(n_pods, ...)`` leaf included).  Gradients cross the wire as posit16/posit8
patterns; the reductions a hierarchical cross-pod sync runs on them --
``combine_compressed``, ``scale_compressed``, ``mean_compressed`` --
stay in the posit domain on the fused elementwise kernel
(``kernels.ops``), one rounding per op and no f32 round trip.  Trees are
nested dicts, lists and tuples of tensors (``repro_torch.tree``).
"""
from __future__ import annotations

import torch

from repro_torch.core import softposit_ref
from repro_torch.core.types import POSIT8, POSIT16, PositConfig, to_storage
from repro_torch.kernels import ops as kops
from repro_torch.kernels import posit_codec
from repro_torch.tree import leaves, tree_map, unflatten

_CFGS = {"posit16": POSIT16, "posit8": POSIT8}


def pcfg_of(name: str) -> PositConfig:
    return _CFGS[name]


def init_error_state(params):
    """Zero f32 residuals shaped like ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_with_feedback(grads, error, name: str):
    """Returns ``(patterns tree, new error tree)``."""
    cfg = pcfg_of(name)
    qs, es = [], []
    for g, e in zip(leaves(grads), leaves(error)):
        buf = (g.to(torch.float32) + e).contiguous()
        qs.append(posit_codec.quantize(buf, cfg))
        es.append(buf - posit_codec.dequantize(qs[-1], cfg))
    return unflatten(grads, qs), unflatten(grads, es)


def decompress(patterns, name: str):
    """Patterns -> f32, leaf by leaf: row 2's kernel on a CUDA tensor
    (one launch a leaf), its plain version on the CPU."""
    cfg = pcfg_of(name)
    return tree_map(lambda q: posit_codec.dequantize(q.contiguous(), cfg), patterns)


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
