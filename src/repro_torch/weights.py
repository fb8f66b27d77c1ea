"""Carry parameters and paged caches over from the reference's layout.

The reference keeps parameters as a nested dict pytree whose per-layer
leaves are stacked on axis 0 (``jax.vmap`` over the layer keys) and
caches as dicts of arrays.  These converters take those trees as nested
dicts of numpy arrays (no JAX needed) and return the port's layout:
each stacked per-layer tree becomes a list of per-layer dicts, and a
cache's ``len`` and ``max_len`` become Python ints.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(x, device, dtype=None):
    t = torch.from_numpy(np.array(x, copy=True, order="C"))
    return t.to(device=device, dtype=dtype) if dtype is not None \
        else t.to(device)


# per-layer trees the reference stacks on axis 0, and the layer count of each
_STACKED = {"layers": lambda cfg: cfg.n_layers,
            "enc_layers": lambda cfg: cfg.encoder_layers or cfg.n_layers,
            "dec_layers": lambda cfg: cfg.n_layers}
# leaves the reference reads in f32 whatever the compute dtype: norm scales,
# the layer norms' biases, rwkv6's decay base and bonus, hymba's SSM decay,
# step bias and skip
_F32_LEAVES = frozenset({"scale", "bias", "w0", "u", "A_log", "dt_bias", "D"})


def _convert(tree, device, dtype, key=None):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, k) for k, v in tree.items()}
    return _tensor(tree, device, None if key in _F32_LEAVES else dtype)


def params_from_jax(tree, cfg, *, device="cuda", dtype=None):
    """Reference parameter pytree (nested dicts of numpy arrays) -> port
    parameters on ``device``.  Every stacked per-layer tree (``layers``;
    whisper's ``enc_layers`` and ``dec_layers``) becomes a list of
    per-layer dicts; other leaves stay whole.  ``dtype`` (e.g.
    ``torch.bfloat16``) stores every leaf in that dtype except the ones
    the reference reads in f32 (``_F32_LEAVES``); the forward casts the
    others to the compute dtype either way."""
    dev = resolve_device(device)

    def layer(i, t):
        if isinstance(t, dict):
            return {k: layer(i, v) for k, v in t.items()}
        return np.asarray(t)[i]

    out = {}
    for k, v in tree.items():
        if k in _STACKED:
            out[k] = [_convert(layer(i, v), dev, dtype)
                      for i in range(_STACKED[k](cfg))]
        else:
            out[k] = _convert(v, dev, dtype, k)
    return out


def cache_from_jax(tree, *, device="cuda"):
    """Reference cache, paged or linear (dict of numpy arrays) -> port
    cache on ``device``; posit patterns keep their unsigned dtype and the
    scalars ``len`` and ``max_len`` become Python ints."""
    dev = resolve_device(device)
    out = {}
    for k, v in tree.items():
        out[k] = int(np.asarray(v)) if k in ("len", "max_len") else _tensor(v, dev)
    return out
