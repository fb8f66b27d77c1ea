"""Architectures the port can serve: ``--arch <id>`` resolves here.

The dense GQA lane (phi3-medium-14b) and the MLA lane (minicpm3-4b)
are served; the other reference architectures join as their lanes are
ported.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import minicpm3_4b, phi3_medium_14b

_MODULES = {
    "phi3-medium-14b": phi3_medium_14b,
    "minicpm3-4b": minicpm3_4b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].CONFIG
