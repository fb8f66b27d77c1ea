"""Fault tolerance & straggler mitigation for the training supervisor.

A copy of ``repro/runtime/fault.py`` (pure Python) over the port's
``Checkpointer``.

* ``StragglerWatchdog`` — EWMA step-time monitor; flags steps whose
  duration exceeds ``threshold`` x the moving average.  On a real cluster
  the flag triggers hot-spare swap / re-slicing; here it feeds metrics
  and the supervisor log (and is unit-tested with synthetic timings).
* ``TrainSupervisor`` — crash-safe outer loop: checkpoint every
  ``save_every`` steps, auto-resume from the latest complete checkpoint,
  bounded restarts.  Failure injection hooks make this testable on CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.checkpoint.checkpointer import Checkpointer


@dataclasses.dataclass
class StragglerWatchdog:
    alpha: float = 0.2            # EWMA weight
    threshold: float = 2.5        # x mean -> straggler
    warmup: int = 3
    _mean: float = 0.0
    _count: int = 0
    stragglers: int = 0

    def observe(self, dt: float) -> bool:
        self._count += 1
        if self._count <= self.warmup:
            self._mean = dt if self._mean == 0 else \
                (self._mean + dt) / 2
            return False
        is_straggler = dt > self.threshold * self._mean
        if is_straggler:
            self.stragglers += 1
        else:
            self._mean = (1 - self.alpha) * self._mean + self.alpha * dt
        return is_straggler


class TrainSupervisor:
    def __init__(self, checkpointer: Checkpointer, *,
                 save_every: int = 50, max_restarts: int = 3,
                 watchdog: Optional[StragglerWatchdog] = None):
        self.ckpt = checkpointer
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.watchdog = watchdog or StragglerWatchdog()
        self.restarts = 0
        self.events = []

    def run(self, *, state, step_fn: Callable, total_steps: int,
            fail_hook: Optional[Callable] = None):
        """Run ``step_fn(state, step) -> state`` with checkpoint/restart.

        ``state`` must be a tree of tensors (``repro_torch.tree``);
        ``fail_hook(step)`` may raise to simulate node failure (tests).
        Returns (final state, steps executed including replays).
        """
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            state, start = self.ckpt.restore(latest, state)
            self.events.append(("resume", start))
        executed = 0
        step = start
        while step < total_steps:
            try:
                t0 = time.monotonic()
                if fail_hook is not None:
                    fail_hook(step)
                state = step_fn(state, step)
                executed += 1
                if self.watchdog.observe(time.monotonic() - t0):
                    self.events.append(("straggler", step))
                step += 1
                if step % self.save_every == 0 or step == total_steps:
                    self.ckpt.save(step, state)
            except Exception as e:                      # noqa: BLE001
                self.restarts += 1
                self.events.append(("failure", step, repr(e)))
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.max_restarts}") from e
                latest = self.ckpt.latest_step()
                if latest is not None:
                    state, step = self.ckpt.restore(latest, state)
                else:
                    step = 0
                self.events.append(("resume", step))
        self.ckpt.wait()
        return state, executed
