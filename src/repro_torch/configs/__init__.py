"""Architectures the port can serve: ``--arch <id>`` resolves here.

Only dense-attention transformers are served so far; the other
reference architectures join as their lanes are ported.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import phi3_medium_14b

_MODULES = {
    "phi3-medium-14b": phi3_medium_14b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].CONFIG
