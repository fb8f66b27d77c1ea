"""Carry parameters and paged caches over from the reference's layout.

The reference keeps parameters as a nested dict pytree whose per-layer
leaves are stacked on axis 0 (``jax.vmap`` over the layer keys) and
caches as dicts of arrays.  These converters take those trees as nested
dicts of numpy arrays (no JAX needed) and return the port's layout:
``params["layers"]`` becomes a list of per-layer dicts, and a cache's
``len`` and ``max_len`` become Python ints.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(x, device, dtype=None):
    t = torch.from_numpy(np.array(x, copy=True, order="C"))
    return t.to(device=device, dtype=dtype) if dtype is not None \
        else t.to(device)


def _convert(tree, device, dtype, key=None):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, k) for k, v in tree.items()}
    # norm scales stay f32; every other leaf may take ``dtype``
    return _tensor(tree, device, None if key == "scale" else dtype)


def params_from_jax(tree, cfg, *, device="cuda", dtype=None):
    """Reference parameter pytree (nested dicts of numpy arrays) -> port
    parameters on ``device``.  ``dtype`` (e.g. ``torch.bfloat16``) stores
    every weight in that dtype except the norm scales, which stay f32;
    the forward casts weights to the compute dtype either way."""
    dev = resolve_device(device)
    layers = tree["layers"]
    n = cfg.n_layers

    def layer(i, t):
        if isinstance(t, dict):
            return {k: layer(i, v) for k, v in t.items()}
        return np.asarray(t)[i]

    out = {k: _convert(v, dev, dtype, k) for k, v in tree.items()
           if k != "layers"}
    out["layers"] = [_convert(layer(i, layers), dev, dtype) for i in range(n)]
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
