"""Posit configuration types.

``PositConfig`` carries the posit width ``nbits``, the exponent field
width ``es`` and the alignment width of the PVU datapath.  Patterns are
stored in the narrowest unsigned torch dtype (``storage_dtype``): one
byte for posit8, two for posit16, four for posit32 -- never widened,
since those bytes are the point of the format.  Arithmetic on patterns
runs in int64 (torch's ``uint16``/``uint32`` lack shifts, ``+`` and
comparisons).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PositConfig:
    nbits: int = 32
    es: int = 2
    align_width: int = 63

    def __post_init__(self):
        if not (2 <= self.nbits <= 32):
            raise ValueError(f"nbits must be in [2, 32], got {self.nbits}")
        if not (0 <= self.es <= 4):
            raise ValueError(f"es must be in [0, 4], got {self.es}")
        if not (1 <= self.align_width <= 63):
            raise ValueError("align_width must be in [1, 63]")

    @property
    def useed(self) -> int:
        return 1 << (1 << self.es)

    @property
    def mask(self) -> int:
        """Mask of the low ``nbits`` bits."""
        return (1 << self.nbits) - 1 if self.nbits < 32 else 0xFFFFFFFF

    @property
    def nar_pattern(self) -> int:
        return 1 << (self.nbits - 1)

    @property
    def maxpos_pattern(self) -> int:
        return (1 << (self.nbits - 1)) - 1

    @property
    def minpos_pattern(self) -> int:
        return 1

    @property
    def max_scale(self) -> int:
        """Largest combined binary exponent (maxpos): (n-2) * 2^es."""
        return (self.nbits - 2) << self.es

    @property
    def min_scale(self) -> int:
        return -self.max_scale

    @property
    def max_frac_bits(self) -> int:
        """Longest possible fraction field: n - 1 (sign) - 2 (min regime) - es."""
        return max(0, self.nbits - 3 - self.es)

    @property
    def storage_dtype(self) -> torch.dtype:
        """Narrowest unsigned torch dtype that holds a pattern."""
        if self.nbits <= 8:
            return torch.uint8
        if self.nbits <= 16:
            return torch.uint16
        return torch.uint32

    @property
    def name(self) -> str:
        return f"posit{self.nbits}e{self.es}"


# The Posit Standard's es = 2 at three widths (the paper evaluates
# posit16 and posit32) and two narrower-exponent variants.
POSIT32 = PositConfig(32, 2)
POSIT16 = PositConfig(16, 2)
POSIT8 = PositConfig(8, 2)
POSIT16_E1 = PositConfig(16, 1)
POSIT8_E0 = PositConfig(8, 0)
CONFIGS = (POSIT32, POSIT16, POSIT8, POSIT16_E1, POSIT8_E0)


# torch implements few kernels for uint16/uint32 (no indexing, stacking
# or filling on CUDA), so pattern tensors move through a signed view of
# the same bytes and are viewed back.
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def signed_view(t: torch.Tensor) -> torch.Tensor:
    """Same-width signed view of an unsigned pattern tensor (other
    tensors are returned as they are)."""
    return t.view(_SIGNED[t.dtype]) if t.dtype in _SIGNED else t


def index_rows(t: torch.Tensor, idx) -> torch.Tensor:
    """``t[idx]`` for any dtype, unsigned patterns included."""
    return signed_view(t)[idx].view(t.dtype)


def zeros(shape, dtype: torch.dtype, device=None) -> torch.Tensor:
    """``torch.zeros`` for any dtype, unsigned patterns included."""
    return torch.zeros(shape, dtype=_SIGNED.get(dtype, dtype),
                       device=device).view(dtype)


def to_storage(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 values in ``[0, 2**bits)`` -> ``dtype`` with the same bits."""
    if dtype in _SIGNED:
        bits = 8 * torch.empty((), dtype=dtype).element_size()
        x = torch.where(x >= 1 << (bits - 1), x - (1 << bits), x)
        return x.to(_SIGNED[dtype]).view(dtype)
    return x.to(dtype)
