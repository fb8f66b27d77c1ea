"""Architectures the port can serve: ``--arch <id>`` resolves here.

Every transformer-family architecture of the reference is served: the
dense GQA lane (phi3-medium-14b, gemma-7b, granite-34b, and
internvl2-1b with its visual prefix), the MLA lane (minicpm3-4b) and
the MoE feed-forward (granite-moe-3b-a800m, dbrx-132b).  The other
families (hymba, rwkv6, whisper) join as they are ported.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import (dbrx_132b, gemma_7b, granite_34b, granite_moe_3b_a800m,
               internvl2_1b, minicpm3_4b, phi3_medium_14b)

_MODULES = {
    "internvl2-1b": internvl2_1b,
    "phi3-medium-14b": phi3_medium_14b,
    "gemma-7b": gemma_7b,
    "granite-34b": granite_34b,
    "minicpm3-4b": minicpm3_4b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "dbrx-132b": dbrx_132b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].CONFIG
