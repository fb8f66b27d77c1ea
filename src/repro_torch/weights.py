"""Carry parameters and paged caches over from the reference's layout.

The reference keeps parameters as a nested dict pytree whose per-layer
leaves are stacked on axis 0 (``jax.vmap`` over the layer keys) and
caches as dicts of arrays.  These converters take those trees as nested
dicts of numpy arrays (no JAX needed) and return the port's layout:
each stacked per-layer tree becomes a list of per-layer dicts, and a
cache's ``len`` and ``max_len`` become Python ints.  ``params_to_jax``
is the inverse for parameter (and gradient) trees.
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


def _host(t):
    """A tensor as numpy: bf16 as f32, unsigned patterns as themselves."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.to(torch.float32).numpy()
    if t.dtype == torch.uint16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_to_jax(tree):
    """Port parameters (or gradients, or any tree of the same layout) ->
    the reference's layout as nested dicts of numpy arrays: every
    per-layer list is stacked back on a new axis 0."""
    if isinstance(tree, dict):
        return {k: params_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        layers = [params_to_jax(v) for v in tree]

        def stack(*xs):
            if isinstance(xs[0], dict):
                return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
            return np.stack(xs)
        return stack(*layers)
    return _host(tree)
