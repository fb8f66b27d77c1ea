"""Timing of one kernel launch on the card, shared by ``chip_smoke.py``
and the launch scripts: alone (back-to-back launches between one CUDA
event pair) and on the card's own clock (``torch.profiler``)."""
from __future__ import annotations

import torch


def kernel_alone_ms(call, n: int = 100) -> float:
    """Time of one launch alone: ``n`` back-to-back calls of the loaded
    library function on preallocated outputs (``call`` from a wrapper's
    ``*_call``, returning the CUDA error code), bracketed by one event
    pair, divided by ``n``; the wrapper's Python checks and allocations
    are outside.  Raises if a warm-up launch returns an error."""
    for _ in range(3):
        if call() != 0:
            raise RuntimeError("a kernel-alone launch returned a CUDA error")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(call, kernel: str, n: int = 50):
    """Device time of one launch of ``kernel`` (a substring of its name)
    from ``torch.profiler``'s trace of ``n`` calls, or None when the trace
    holds no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    total = count = 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            t = getattr(ev, "device_time_total", None)
            total += ev.cuda_time_total if t is None else t
            count += ev.count
    return total / count / 1e3 if count else None
