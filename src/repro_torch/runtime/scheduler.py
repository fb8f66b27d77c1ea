"""Continuous-batching request scheduler (chunked paged mode).

The port of ``repro/runtime/scheduler.py`` with ``chunked_prefill=True``
over a paged engine.  The cache's batch dimension is a slot pool; every
scheduling round

    admit queued prompts into free slots (allocation only: block table,
    ``lens = 0``)  ->  extend live rows' tables for the round's writes
    ->  ONE ``Engine.mixed_step`` (a prefill chunk for every prefilling
    row, the decode quantum for every decoding row)  ->  advance prompt
    cursors, sample first tokens for rows whose prompt completed, emit
    decode tokens  ->  retire finished rows (free their blocks).

Each request's worst-case block demand is reserved at admission, so
table extension never finds the pool empty; admission defers (FIFO)
while the reservation does not fit.  Greedy token streams equal the
reference scheduler's.

Not ported yet: the prefix cache with copy-on-write, EDF deadlines with
preemption, the unchunked and the dense (non-paged) modes, and the
arena-sanitizer gates.

Time is counted in decode steps (the simulation clock); each round is
also wall-timed (``stats['step_wall_p50_ms']``/``['step_wall_p99_ms']``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.compress import kvcache as kvc
from .engine import Engine, sample_token


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int
    eos_id: Optional[int] = None
    arrival_step: int = 0          # simulation clock at submit()


@dataclasses.dataclass
class Completion:
    rid: int
    prompt_len: int
    tokens: np.ndarray             # (n,) int32, truncated at EOS/max_new
    arrival_step: int
    admitted_step: int
    finished_step: int

    @property
    def latency_steps(self) -> int:
        return self.finished_step - self.arrival_step


@dataclasses.dataclass
class _Slot:
    req: Request
    emitted: list
    admitted_step: int
    done: bool = False
    # prompt positions already cached, or None once the prompt is in
    cursor: Optional[int] = None

    @property
    def lens(self) -> int:
        """Row's cache occupancy (mirrors the device ``lens`` entry)."""
        if self.cursor is not None:
            return self.cursor
        return len(self.req.prompt) + len(self.emitted) - 1


class Scheduler:
    """Iteration-level batching over a paged :class:`Engine`.

    ``n_slots`` is the pool width, ``chunk_size`` both the prefill chunk
    width and the decode steps per round.  Only ``chunked_prefill=True``
    is ported.
    """

    def __init__(self, engine: Engine, *, n_slots: int, chunk_size: int = 8,
                 eos_id: Optional[int] = None, chunked_prefill: bool = True):
        if not chunked_prefill:
            raise NotImplementedError(
                "only the chunked-prefill scheduler is ported "
                "(chunked_prefill=True)")
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.engine = engine
        self.n_slots = int(n_slots)
        self.chunk_size = int(chunk_size)
        self.eos_id = eos_id
        self.block_size = engine.block_size
        self.table_width = engine.table_width
        self.n_blocks = engine.n_blocks or self.n_slots * self.table_width
        self.pool = kvc.BlockPool(self.n_blocks)
        self.cache = engine.init_cache(self.n_slots)
        self._tables = np.full((self.n_slots, self.table_width),
                               self.n_blocks, np.int32)
        self._row_blocks: list = [[] for _ in range(self.n_slots)]
        self._row_used = [0] * self.n_slots   # populated table slots
        self._worst = [0] * self.n_slots
        self._outstanding = 0      # reserved-but-unallocated blocks
        # high-water mark of allocated + reserved blocks: an arena of
        # this size replays the trace with zero deferrals
        self.peak_committed = 0
        self.prefill_tokens = 0
        self._slots: list = [None] * self.n_slots
        self._queue: deque = deque()
        self._cur_tok = np.zeros((self.n_slots,), np.int64)
        self._next_rid = 0
        self.steps_run = 0
        self._step_wall_ms: list = []
        self.n_chunks = 0
        self.n_admitted = 0
        self.n_retired = 0

    # ------------------------------------------------------------------
    # queue
    # ------------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               eos_id: Optional[int] = None) -> int:
        """Enqueue a request; returns its id.  Raises up front if it could
        never fit: ``prompt + max_new - 1`` cache slots plus a chunk of
        headroom, and its worst-case block demand."""
        prompt = [int(t) for t in prompt]
        max_new_tokens = int(max_new_tokens)
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        need = len(prompt) + max_new_tokens - 1 + self.chunk_size
        if need > self.engine.max_len:
            raise ValueError(
                f"request needs up to {need} cache slots (prompt "
                f"{len(prompt)} + {max_new_tokens} new + chunk "
                f"{self.chunk_size} headroom) > engine max_len "
                f"{self.engine.max_len}")
        worst = self._worst_blocks(len(prompt), max_new_tokens)
        if worst > self.n_blocks:
            raise ValueError(
                f"request needs up to {worst} cache blocks > block pool "
                f"capacity {self.n_blocks} (block_size {self.block_size})")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(
            rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
            eos_id=self.eos_id if eos_id is None else eos_id,
            arrival_step=self.steps_run))
        return rid

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    @property
    def n_active(self) -> int:
        return sum(1 for s in self._slots if s is not None and not s.done)

    @property
    def stats(self) -> dict:
        """Counters of the run; ``step_wall_*_ms`` are real per-round wall
        times (0.0 before the first round)."""
        wall = np.asarray(self._step_wall_ms, np.float64)
        return dict(
            n_admitted=self.n_admitted, n_retired=self.n_retired,
            n_chunks=self.n_chunks, steps_run=self.steps_run,
            step_wall_p50_ms=float(np.percentile(wall, 50))
            if wall.size else 0.0,
            step_wall_p99_ms=float(np.percentile(wall, 99))
            if wall.size else 0.0,
            prefill_tokens=self.prefill_tokens,
            n_compiles=self.engine.n_compiles,
            peak_committed=self.peak_committed)

    # ------------------------------------------------------------------
    # block accounting
    # ------------------------------------------------------------------

    def _worst_blocks(self, prompt_len: int, max_new: int) -> int:
        """Most blocks a request can hold at once (a row can overshoot its
        stopping point by up to a chunk)."""
        return self.engine._row_blocks_needed(
            prompt_len, max_new - 1 + self.chunk_size)

    def _row_debt(self, row: int) -> int:
        """Blocks reserved but not yet drawn for a live row."""
        return self._worst[row] - len(self._row_blocks[row])

    def _note_peaks(self):
        self.peak_committed = max(self.peak_committed,
                                  self.pool.in_use + self._outstanding)

    def _set_device_tables(self):
        self.cache = dict(self.cache, block_tables=torch.as_tensor(
            self._tables, device=self.engine.device))

    def _admit_chunked(self, req: Request, row: int):
        """Allocate a row for ``req``: block table and ``lens = 0``; the
        prompt flows through later rounds' chunks.  Returns the chunk
        cursor (0), or ``None`` while the pool cannot cover the
        request's reservation."""
        plen = len(req.prompt)
        worst = self._worst_blocks(plen, req.max_new_tokens)
        if self.pool.n_free - self._outstanding < worst:
            return None                # wait for retirements' blocks
        used = self.table_width if self.engine.window_lane else \
            -(-plen // self.block_size)
        fresh = self.pool.alloc(used)
        self._tables[row] = self.n_blocks
        self._tables[row, :used] = fresh
        self.cache["lens"][row] = 0
        self._set_device_tables()
        self._row_blocks[row] = list(fresh)
        self._row_used[row] = used
        self._worst[row] = worst
        self._outstanding += self._row_debt(row)
        self._note_peaks()
        return 0

    def _ensure_blocks(self):
        """Extend each live decoding dense row's table to cover the next
        round's writes (window rows recycle their ring in place; prompt
        blocks were allocated whole at admission).  The admission-time
        reservation guarantees the pool can serve this."""
        changed = False
        for i, slot in enumerate(self._slots):
            if slot is None or slot.done or self.engine.window_lane:
                continue
            if slot.cursor is not None:
                continue
            need = -(-min(slot.lens + self.chunk_size,
                          self.engine.max_len) // self.block_size)
            have = self._row_used[i]
            if need > have:
                ids = self.pool.alloc(need - have)
                self._tables[i, have:need] = ids
                self._row_blocks[i].extend(ids)
                self._row_used[i] = need
                self._outstanding -= len(ids)
                changed = True
        if changed:
            self._set_device_tables()

    def _admit(self):
        free = [i for i, s in enumerate(self._slots) if s is None]
        while self._queue and free:
            req = self._queue[0]
            row = free[0]
            cursor = self._admit_chunked(req, row)
            if cursor is None:         # FIFO: do not admit around the head
                break
            self._queue.popleft()
            free.remove(row)
            self._slots[row] = _Slot(req=req, emitted=[],
                                     admitted_step=self.steps_run,
                                     cursor=cursor)
            self.n_admitted += 1

    def _retire(self):
        done_mask = np.zeros((self.n_slots,), bool)
        completions = []
        for i, slot in enumerate(self._slots):
            if slot is None or not slot.done:
                continue
            done_mask[i] = True
            req = slot.req
            completions.append(Completion(
                rid=req.rid, prompt_len=len(req.prompt),
                tokens=np.asarray(slot.emitted, np.int32),
                arrival_step=req.arrival_step,
                admitted_step=slot.admitted_step,
                finished_step=self.steps_run))
            self._slots[i] = None
            self.n_retired += 1
            self._outstanding -= self._row_debt(i)
            self.pool.free(self._row_blocks[i])
            self._row_blocks[i] = []
            self._row_used[i] = 0
            self._worst[i] = 0
            self._tables[i] = self.n_blocks          # sentinel
        if done_mask.any():
            self.cache = kvc.paged_release_rows(
                self.cache, torch.as_tensor(done_mask, device=self.engine.device))
        return completions

    def _step_chunked(self):
        self._admit()
        decode_active = np.array(
            [s is not None and not s.done and s.cursor is None
             for s in self._slots], bool)
        nv = np.zeros((self.n_slots,), np.int32)
        chunk = np.full((self.n_slots, self.chunk_size), self.engine.pad_id,
                        np.int64)
        for i, s in enumerate(self._slots):
            if s is None or s.done or s.cursor is None:
                continue
            n = min(self.chunk_size, len(s.req.prompt) - s.cursor)
            nv[i] = n
            chunk[i, :n] = s.req.prompt[s.cursor:s.cursor + n]
        if not decode_active.any() and not nv.any():
            return self._retire()
        self._ensure_blocks()
        self.cache, chunk_logits, toks = self.engine.mixed_step(
            self.cache, chunk, nv, self._cur_tok, self.chunk_size,
            decode_active=decode_active)
        toks = toks.cpu().numpy()
        self.steps_run += self.chunk_size
        self.n_chunks += 1

        for i, s in enumerate(self._slots):
            if s is None or s.done:
                continue
            req = s.req
            if decode_active[i]:
                for t in toks[i]:
                    s.emitted.append(int(t))
                    if int(t) == req.eos_id or \
                            len(s.emitted) >= req.max_new_tokens:
                        s.done = True
                        break
                self._cur_tok[i] = toks[i, -1]
            elif nv[i]:
                s.cursor += int(nv[i])
                self.prefill_tokens += int(nv[i])
                if s.cursor >= len(req.prompt):
                    # prompt complete: the first token comes from the
                    # chunk's last-valid-position logits
                    s.cursor = None
                    tok0 = int(sample_token(chunk_logits[i:i + 1],
                                            self.engine.gen,
                                            self.engine.temperature)[0])
                    s.emitted.append(tok0)
                    self._cur_tok[i] = tok0
                    if tok0 == req.eos_id or req.max_new_tokens == 1:
                        s.done = True
        return self._retire()

    def step(self):
        """One scheduling round (wall-timed); returns the requests
        completed in it."""
        t0 = time.perf_counter()
        try:
            return self._step_chunked()
        finally:
            self._step_wall_ms.append((time.perf_counter() - t0) * 1e3)

    def run(self, max_rounds: Optional[int] = None):
        """Drain queue and slots; returns ``{rid: Completion}``."""
        out = {}
        rounds = 0
        while self.has_work:
            if max_rounds is not None and rounds >= max_rounds:
                raise RuntimeError(
                    f"scheduler did not drain in {max_rounds} rounds "
                    f"({len(self._queue)} queued, {self.n_active} active)")
            for c in self.step():
                out[c.rid] = c
            rounds += 1
        return out
