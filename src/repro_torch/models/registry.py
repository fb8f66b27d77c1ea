"""Model family registry: one protocol over the four families.

Each family module provides ``init_params(cfg, *, seed, device,
dtype)``, ``train_loss(params, batch, cfg, *, denom=None)`` (the
transformer's takes ``tp=`` too) and ``loss_labels(batch, cfg)``,
``logits_fn(params,
tokens, cfg, ...)``, ``init_cache(cfg, batch, max_len, *, device)``,
``prefill(params, tokens, cfg, ..., max_len=)`` and
``decode_step(params, cache, token, cfg, ...)``.
"""
from __future__ import annotations

from types import SimpleNamespace

from . import hymba, rwkv6, transformer, whisper
from .config import ModelConfig

_FAMILIES = {
    "transformer": transformer,
    "rwkv6": rwkv6,
    "hymba": hymba,
    "whisper": whisper,
}


def get_family(cfg: ModelConfig):
    """The module implementing the protocol for ``cfg``."""
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family {cfg.family!r}") from None


def build(cfg: ModelConfig, *, device="cuda"):
    """The protocol's functions bound to ``cfg`` and ``device``."""
    fam = get_family(cfg)
    return SimpleNamespace(
        cfg=cfg,
        init_params=lambda seed=0, dtype=None: fam.init_params(
            cfg, seed=seed, device=device, dtype=dtype),
        train_loss=lambda params, batch: fam.train_loss(params, batch, cfg),
        logits=lambda params, tokens, **kw: fam.logits_fn(params, tokens, cfg, **kw),
        init_cache=lambda batch, max_len: fam.init_cache(cfg, batch, max_len,
                                                         device=device),
        prefill=lambda params, tokens, **kw: fam.prefill(params, tokens, cfg, **kw),
        decode_step=lambda params, cache, token, **kw: fam.decode_step(
            params, cache, token, cfg, **kw),
    )
