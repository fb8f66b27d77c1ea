"""Bit primitives on uint32 values held in int64 tensors.

torch's ``uint32`` has no shifts, ``+`` or comparisons, so a 32-bit
lane is an int64 tensor whose value lies in ``[0, 2**32)``; every helper
that can carry past bit 31 masks with ``M32``.  Shift amounts are int64
tensors or Python ints.

* ``clz32``       -- leading-zero count (32 for 0), branch-free.
* ``sll``/``srl`` -- total shifts: any amount, 0 once it is outside
                     ``[0, 32)`` (the codec relies on that wrap).
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
I64 = torch.int64


def u32(x, like=None) -> torch.Tensor:
    """``x`` as an int64 tensor reduced to 32 bits."""
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=I64, device=dev) & M32


def i64(x, like=None) -> torch.Tensor:
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=I64, device=dev)


def sll(x, s):
    """``x << s`` on 32 bits; 0 when ``s`` is outside ``[0, 32)``."""
    x = u32(x, s)
    s = i64(s, x)
    out = (x << s.clamp(0, 31)) & M32
    return torch.where((s >= 0) & (s < 32), out, torch.zeros_like(out))


def srl(x, s):
    """Logical ``x >> s``; 0 when ``s`` is outside ``[0, 32)``."""
    x = u32(x, s)
    s = i64(s, x)
    out = x >> s.clamp(0, 31)
    return torch.where((s >= 0) & (s < 32), out, torch.zeros_like(out))


def clz32(x):
    """Count leading zeros of a 32-bit value (32 for 0)."""
    x = u32(x)
    n = torch.zeros_like(x)
    cur = x
    for k in (16, 8, 4, 2, 1):
        cond = cur < (1 << (32 - k))
        n = n + torch.where(cond, k, 0)
        cur = torch.where(cond, (cur << k) & M32, cur)
    return torch.where(x == 0, 32, n)
