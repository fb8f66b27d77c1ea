"""Architectures the port can serve: ``--arch <id>`` resolves here.

Every architecture of the reference is served, in the reference's
order: the transformer family's dense GQA lane (phi3-medium-14b,
gemma-7b, granite-34b, and internvl2-1b with its visual prefix), MLA
lane (minicpm3-4b) and MoE feed-forward (granite-moe-3b-a800m,
dbrx-132b); the hybrid hymba-1.5b (sliding-window ring caches, three
global layers, SSM state); the attention-free rwkv6-7b (O(1) recurrent
state); and the encoder-decoder whisper-tiny (encoder frames, a
cross-attention cache).  Only the transformer family runs the
continuous-batching scheduler and the paged cache.

The dry run's grid (``launch/dryrun.py``) is :func:`all_cells`: each
architecture's ``SUPPORTED_SHAPES`` (``shapes.py``), each cell's config
from :func:`config_for_cell`.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

from . import (dbrx_132b, gemma_7b, granite_34b, granite_moe_3b_a800m,
               hymba_1_5b, internvl2_1b, minicpm3_4b, phi3_medium_14b,
               rwkv6_7b, whisper_tiny)
from .shapes import ALL_SHAPES, SHAPES, ShapeSpec  # noqa: F401

_MODULES = {
    "internvl2-1b": internvl2_1b,
    "rwkv6-7b": rwkv6_7b,
    "phi3-medium-14b": phi3_medium_14b,
    "gemma-7b": gemma_7b,
    "granite-34b": granite_34b,
    "minicpm3-4b": minicpm3_4b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "dbrx-132b": dbrx_132b,
    "hymba-1.5b": hymba_1_5b,
    "whisper-tiny": whisper_tiny,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].CONFIG


def supported_shapes(arch: str):
    return _MODULES[arch].SUPPORTED_SHAPES


def config_for_cell(arch: str, shape: str) -> ModelConfig:
    """The architecture's config for a dry-run cell: a decode cell takes
    the module's ``SERVE_OVERRIDES`` (its serving memory policy), or
    posit16 KV where the module has none."""
    mod = _MODULES[arch]
    cfg = mod.CONFIG
    if SHAPES[shape].kind == "decode":
        cfg = dataclasses.replace(cfg, **getattr(mod, "SERVE_OVERRIDES",
                                                 dict(kv_posit="posit16")))
    return cfg


def all_cells():
    """Every (arch, shape) pair of the dry run's grid, in ``ARCH_IDS``
    order."""
    for arch in ARCH_IDS:
        for shape in supported_shapes(arch):
            yield arch, shape
