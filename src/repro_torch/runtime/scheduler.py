"""Continuous-batching request scheduler.

The port of ``repro/runtime/scheduler.py``, in its three modes.  The
cache's batch dimension is a slot pool; every scheduling round admits
queued prompts into free slots, runs one decode quantum of
``chunk_size`` steps for the live rows (inactive rows ride along with
frozen ``lens``; their tokens are discarded) and retires finished rows.

* **Dense-cache mode** (``Engine(paged=False)``, the default): one
  linear cache with a shared padded write frontier.  Admission prefills
  the prompt alone (batch 1, the KV an isolated ``Engine.generate``
  computes), samples its first token, raises the frontier for a long
  prompt (``kvcache.compact``) and grafts the row in
  (``kvcache.adopt_row``).  Retirement wipes the row
  (``kvcache.reset_slots``); before a quantum that would run past
  ``max_len`` the frontier is pulled back to the longest live row.
* **Unchunked paged mode** (``Engine(paged=True)``): row-local block
  tables, no compaction.  Admission prefills the prompt linearly and
  packs its patterns into freshly allocated blocks
  (``kvcache.paged_adopt_row``); live rows extend their tables between
  quanta.
* **Chunked paged mode** (``chunked_prefill=True``): admission only
  allocates (block table, ``lens`` cursor, prefix borrows); every round
  is ONE ``Engine.mixed_step``: a prefill chunk for every prefilling
  row and the decode quantum for every decoding row.  A row whose
  prompt completes samples its first token from the chunk's logits.

In both paged modes each request's worst-case block demand is reserved
at admission, so table extension and copy-on-write never find the pool
empty; admission defers while the reservation does not fit.

Policy: ``submit(..., deadline=)`` attaches an absolute sim-step
deadline.  Admission is earliest-deadline-first (deadline-less requests
last, FIFO among equals; with no deadline in the queue it is plain
FIFO).  When the head cannot get its blocks, the active row with the
latest deadline -- only if strictly later than the head's, so
best-effort never preempts best-effort -- is preempted: its block
references are dropped, its table set to the sentinel and the request
requeued from scratch (greedy decode makes the restart token-identical).

Prefix caching (``prefix_cache=True``): every fully written prompt
block is content-addressed in a :class:`kvcache.PrefixIndex` that holds
one pool reference per block.  Admission borrows the matched leading
blocks (``BlockPool.share``) and starts the chunk cursor after them
(at least the last prompt token reruns: its logits seed the first
token).  Writes never land in a shared block: admission copies the
matched blocks the remaining chunks overlap, the per-round write tables
set every still-borrowed entry to the sentinel, and on the window lane
a pre-round pass copies ring slots about to recycle a shared block.
Index-only blocks are evicted least-recently-matched first when
admission needs physical blocks.

``Engine(sanitize=True)`` arms the sanitizer: pre-round read/write
gates on every live table entry, poisoned reclaims and evictions, and
the ``n_leaked`` gauge from :meth:`Scheduler.leak_report`.

Greedy token streams, and the counters ``prefix_hits``, ``n_cow``,
``n_preempted``, ``peak_committed``, ``peak_logical`` and ``n_compiles``,
equal the reference scheduler's in every mode.

Time is counted in decode steps (the simulation clock); each round is
also wall-timed (``stats['step_wall_p50_ms']``/``['step_wall_p99_ms']``).

Under a tensor-parallel engine (``Engine(mesh=)``, every mode) every
rank runs its own scheduler over its shard.  Its decisions read only host
state and the sampled tokens, which are equal on every rank (the argmax
of full-width logits, or rank 0's draw: ``Engine.sample``), so every
rank reaches rank 0's schedule: the same admissions, block ids and, in
the dense-cache mode, compactions (from the host-side ``lens`` and
frontier).  The arenas are only ever addressed by block ids, which name
one slice of KV heads on each rank; the dense cache's rows and frontier
are the same on every rank, its leaves this rank's KV heads.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.compress import kvcache as kvc
from repro_torch.models import transformer as T
from .engine import Engine


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int
    eos_id: Optional[int] = None
    arrival_step: int = 0          # simulation clock at submit()
    deadline: Optional[int] = None  # absolute sim-step SLO (None = none)


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

    @property
    def queue_steps(self) -> int:
        return self.admitted_step - self.arrival_step


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


def _deadline_key(req: Request) -> float:
    return float("inf") if req.deadline is None else req.deadline


class Scheduler:
    """Iteration-level batching over an :class:`Engine`.

    ``n_slots`` is the pool width, ``chunk_size`` the decode steps per
    round and, in chunked mode, the prefill chunk width.  The mode
    follows ``engine.paged`` and ``chunked_prefill`` (paged engines
    only); ``prefix_cache=True`` (implies chunked prefill) switches on
    prefix sharing with copy-on-write block tables.  The sanitizer
    follows ``engine.sanitize``.
    """

    def __init__(self, engine: Engine, *, n_slots: int, chunk_size: int = 8,
                 eos_id: Optional[int] = None, prefix_cache: bool = False,
                 chunked_prefill: bool = False):
        if engine.cfg.family != "transformer":
            raise ValueError(
                "continuous batching needs per-row decode positions, "
                "which only the transformer family provides (got family="
                f"{engine.cfg.family!r}); hymba/rwkv/whisper decode at a "
                "shared absolute position")
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.engine = engine
        self.n_slots = int(n_slots)
        self.chunk_size = int(chunk_size)
        self.eos_id = eos_id
        self.paged = engine.paged
        self.prefix_cache = bool(prefix_cache)
        # prefix borrows are chunk-cursor skips: sharing rides on chunking
        self.chunked = bool(chunked_prefill) or self.prefix_cache
        self.sanitize = engine.sanitize
        if self.prefix_cache and not self.paged:
            raise ValueError(
                "prefix_cache=True needs Engine(paged=True): sharing is "
                "expressed through block-table entries")
        if self.chunked and not self.paged:
            raise ValueError(
                "chunked_prefill=True needs Engine(paged=True): chunks write "
                "through per-row block tables")
        self._frontier = 0             # host mirror of a linear cache's len
        self.n_compactions = 0         # moves of that frontier (dense-cache mode)
        if self.paged:
            self._init_pool()
        else:
            self.cache = engine.init_cache(self.n_slots)
        self.prefill_tokens = 0        # tokens run through prefill
        self.prefix_hits = 0           # admissions that borrowed blocks
        self.prefix_matched_tokens = 0  # prompt tokens served from cache
        self.n_cow = 0                 # copy-on-write block copies
        self.n_evicted = 0             # index blocks reclaimed
        self.n_leaked = 0              # sanitizer leak gauge
        self.n_preempted = 0           # rows evicted for a deadline
        self._slots: list = [None] * self.n_slots
        self._queue: deque = deque()
        self._cur_tok = np.zeros((self.n_slots,), np.int64)
        self._next_rid = 0
        self.steps_run = 0
        self._step_wall_ms: list = []
        self.n_chunks = 0
        self.n_admitted = 0
        self.n_retired = 0

    def _init_pool(self):
        """The paged modes' arena, block pool and per-row bookkeeping."""
        engine = self.engine
        self.block_size = engine.block_size
        self.table_width = engine.table_width
        self.n_blocks = engine.n_blocks or self.n_slots * self.table_width
        self.pool = kvc.BlockPool(self.n_blocks, sanitize=self.sanitize)
        self.cache = engine.init_cache(self.n_slots)
        self._window = T._paged_window(engine.cfg)
        self._tables = np.full((self.n_slots, self.table_width),
                               self.n_blocks, np.int32)
        self._row_blocks: list = [[] for _ in range(self.n_slots)]
        # borrowed table entries: slot index -> shared block id; the row
        # holds one pool reference per entry and must copy the block
        # before writing through it (empty unless prefix_cache)
        self._row_borrowed: list = [{} for _ in range(self.n_slots)]
        self._row_used = [0] * self.n_slots   # populated table slots
        self._worst = [0] * self.n_slots
        # window rows under prefix caching reserve one copy per prompt
        # block they may register; settled at registration
        self._head_reserved = [0] * self.n_slots
        self._outstanding = 0      # reserved-but-unallocated blocks
        # high-water marks of physical (peak_committed: an arena of this
        # size replays the trace with zero deferrals) and logical
        # (every reference counted: what a non-sharing pool would need)
        # allocated + reserved blocks
        self.peak_committed = 0
        self.peak_logical = 0
        if self.prefix_cache:
            self.index = kvc.PrefixIndex()

    # ------------------------------------------------------------------
    # queue
    # ------------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               eos_id: Optional[int] = None,
               deadline: Optional[int] = None) -> int:
        """Enqueue a request; returns its id.  ``deadline`` is the
        absolute sim step (``steps_run`` clock) it should finish by
        (``None`` = best-effort).  Raises up front if it could never
        fit: ``prompt + max_new - 1`` cache slots plus a chunk of
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
        if self.paged:
            worst = self._worst_blocks(len(prompt), max_new_tokens)
            if self.prefix_cache and self.engine.window_lane and \
                    self._share_cap(len(prompt)):
                # registered ring blocks each pre-reserve one copy
                worst += len(prompt) // self.block_size
            if worst > self.n_blocks:
                raise ValueError(
                    f"request needs up to {worst} cache blocks > block pool "
                    f"capacity {self.n_blocks} (block_size {self.block_size})")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(
            rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
            eos_id=self.eos_id if eos_id is None else eos_id,
            arrival_step=self.steps_run,
            deadline=None if deadline is None else int(deadline)))
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
        d = dict(
            n_admitted=self.n_admitted, n_retired=self.n_retired,
            n_preempted=self.n_preempted, n_chunks=self.n_chunks,
            steps_run=self.steps_run,
            step_wall_p50_ms=float(np.percentile(wall, 50))
            if wall.size else 0.0,
            step_wall_p99_ms=float(np.percentile(wall, 99))
            if wall.size else 0.0,
            prefill_tokens=self.prefill_tokens,
            prefix_hits=self.prefix_hits,
            prefix_matched_tokens=self.prefix_matched_tokens,
            n_cow=self.n_cow, n_evicted=self.n_evicted,
            n_leaked=self.n_leaked,
            n_compiles=self.engine.n_compiles)
        if self.paged:
            d.update(peak_committed=self.peak_committed,
                     peak_logical=self.peak_logical)
        else:
            d.update(n_compactions=self.n_compactions)
        return d

    def _set_frontier(self, target: int):
        """Dense-cache mode: move the shared frontier (``kvcache.compact``)."""
        if target != self._frontier:
            self.n_compactions += 1
            self.cache = kvc.compact(self.cache, target)
            self._frontier = int(target)

    # ------------------------------------------------------------------
    # block accounting
    # ------------------------------------------------------------------

    def _worst_blocks(self, prompt_len: int, max_new: int) -> int:
        """Most blocks a request can hold at once (a row can overshoot its
        stopping point by up to a chunk)."""
        return self.engine._row_blocks_needed(
            prompt_len, max_new - 1 + self.chunk_size)

    def _share_cap(self, plen: int) -> bool:
        """May a prompt of ``plen`` tokens share or register prefix
        blocks?  The window lane shares only prompts that fit the window,
        so donor and sharer map ring slots to the same positions."""
        if not self._window:
            return True
        return plen <= min(self.engine.max_len, self._window)

    def _evictable_count(self, exclude=()) -> int:
        """Index blocks whose only reference is the index's, minus
        ``exclude`` (the blocks the current match is about to pin)."""
        ex = {int(i) for i in exclude}
        return sum(1 for b in self.index.blocks_lru()
                   if b not in ex and self.pool.refcount(b) == 1)

    def _take_blocks(self, n: int) -> list:
        """``pool.alloc(n)``, first evicting least-recently-matched
        index-only blocks while the free list is short.  Callers have
        checked that ``n_free + evictable`` covers their reservation."""
        if n > self.pool.n_free:
            evicted = []
            for bid in self.index.blocks_lru():
                if self.pool.n_free >= n:
                    break
                if self.pool.refcount(bid) == 1:
                    self.index.pop_block(bid)
                    evicted += self.pool.free([bid])
                    self.n_evicted += 1
            if self.sanitize and evicted:
                self.cache = self.engine.poison_blocks(self.cache, evicted)
        return self.pool.alloc(n)

    def _alloc(self, n: int) -> list:
        return self._take_blocks(n) if self.prefix_cache \
            else self.pool.alloc(n)

    def _match_prefix(self, prompt) -> list:
        """Physical ids of the longest chain of resident index blocks
        covering the prompt's leading full blocks."""
        ids = []
        for h in kvc.prefix_block_hashes(prompt, self.block_size):
            bid = self.index.get(h)
            if bid is None:
                break
            ids.append(int(bid))
        return ids

    def _register_row(self, prompt, row: int):
        """Content-address this row's fully written prompt blocks; the
        index takes one pool reference per newly registered block.
        Window rows grow their reservation by one copy per registration
        (ring recycling copies each shared slot at most once), settled
        against what admission pre-reserved."""
        plen = len(prompt)
        reserved, self._head_reserved[row] = self._head_reserved[row], 0
        n_reg = 0
        if self._share_cap(plen):
            for i, h in enumerate(kvc.prefix_block_hashes(
                    prompt, self.block_size)):
                if self.index.get(h) is not None:
                    continue           # first writer wins
                bid = int(self._tables[row, i])
                if bid == self.n_blocks:
                    continue
                self.index.put(h, bid)
                self.pool.share([bid])
                n_reg += 1
        if self.engine.window_lane and (n_reg or reserved):
            self._worst[row] += n_reg - reserved
            self._outstanding += n_reg - reserved

    def _row_debt(self, row: int) -> int:
        """Blocks reserved but not yet drawn for a live row.  Dense-lane
        borrowed entries need no reserve (append-only writes never reach
        a block that lies wholly before the suffix); window-lane ones
        keep theirs (ring recycling copies each at most once)."""
        debt = self._worst[row] - len(self._row_blocks[row])
        if not self.engine.window_lane:
            debt -= len(self._row_borrowed[row])
        return debt

    def _note_peaks(self):
        # index-only blocks are droppable cache, so the physical mark
        # leaves them out
        evictable = self._evictable_count() if self.prefix_cache else 0
        self.peak_committed = max(
            self.peak_committed,
            self.pool.in_use - evictable + self._outstanding)
        self.peak_logical = max(
            self.peak_logical,
            self.pool.logical_in_use + self._outstanding)

    def _set_device_tables(self):
        self.cache = dict(self.cache, block_tables=torch.as_tensor(
            self._tables, device=self.engine.device))

    def _first_token(self, logits) -> int:
        return int(self.engine.sample(logits)[0])

    def _admit_paged(self, req: Request, row: int):
        """Unchunked paged admission: a batch-1 linear prefill (the KV an
        isolated ``Engine.generate`` computes), its patterns packed into
        freshly allocated blocks; no other row moves.  Returns the first
        token, or ``None`` while the pool cannot cover the reservation."""
        plen = len(req.prompt)
        worst = self._worst_blocks(plen, req.max_new_tokens)
        if self.pool.n_free - self._outstanding < worst:
            return None                # wait for retirements' blocks
        row_cache, logits, _ = self.engine.prefill([req.prompt], paged=False)
        now = self.table_width if self.engine.window_lane else \
            -(-plen // self.block_size)
        ids = self.pool.alloc(now)
        block_ids = np.full((self.table_width,), self.n_blocks, np.int32)
        block_ids[:now] = ids
        cap = min(self.engine.max_len, self._window) if self._window \
            else self.engine.max_len
        self.cache = kvc.paged_adopt_row(self.cache, row_cache, row, block_ids,
                                         window=self._window, src_ring=plen > cap)
        self._tables[row] = block_ids
        self._row_blocks[row] = ids
        self._row_borrowed[row] = {}
        self._row_used[row] = now
        self._worst[row] = worst
        self._outstanding += worst - now
        self.prefill_tokens += plen
        self._note_peaks()
        return self._first_token(logits)

    def _admit_dense(self, req: Request, row: int) -> int:
        """Dense-cache admission: a batch-1 prefill grafted into ``row``
        at the shared frontier, raised first for a long prompt.  Returns
        the first token."""
        row_cache, logits, _ = self.engine.prefill([req.prompt])
        tok0 = self._first_token(logits)
        if len(req.prompt) > self._frontier:
            self._set_frontier(len(req.prompt))
        self.cache = kvc.adopt_row(self.cache, row_cache, row)
        return tok0

    def _admit_chunked(self, req: Request, row: int):
        """Allocate a row for ``req``: block table, ``lens`` cursor and
        prefix borrows; the prompt flows through later rounds' chunks.
        Returns the chunk cursor (0, or past the borrowed prefix), or
        ``None`` while the pool cannot cover the reservation."""
        plen = len(req.prompt)
        bs = self.block_size
        worst = self._worst_blocks(plen, req.max_new_tokens)
        matched, suffix_start = [], 0
        if self.prefix_cache and self._share_cap(plen):
            matched = self._match_prefix(req.prompt)
            # matched blocks skip their chunks; the last prompt token
            # always reruns, its logits seed the first token
            suffix_start = min(len(matched) * bs, plen - 1)
        head = plen // bs if (self.prefix_cache and self.engine.window_lane
                              and self._share_cap(plen)) else 0
        avail = self.pool.n_free + (
            self._evictable_count(exclude=matched) if self.prefix_cache
            else 0)
        if avail - self._outstanding < worst + head:
            return None                # wait for retirements' blocks
        used = self.table_width if self.engine.window_lane else \
            -(-plen // bs)
        block_ids = np.full((self.table_width,), self.n_blocks, np.int32)
        borrowed = {}
        if matched and suffix_start > 0:
            cow_from = suffix_start // bs      # first slot chunks write
            n_borrow = min(len(matched), cow_from)
            self.pool.share(matched)   # pin the match before any eviction
            cow_slots = list(range(cow_from, len(matched)))
            fresh = self._take_blocks(used - len(matched) + len(cow_slots))
            block_ids[:len(matched)] = matched
            for s, nid in zip(cow_slots, fresh[:len(cow_slots)]):
                block_ids[s] = nid
            block_ids[len(matched):used] = fresh[len(cow_slots):]
            if cow_slots:
                # copy the shared blocks the chunks will write, then drop
                # this row's reference to the originals (the index keeps
                # them resident)
                self.cache = self.engine.copy_blocks(
                    self.cache, [matched[s] for s in cow_slots],
                    fresh[:len(cow_slots)])
                self.pool.release([matched[s] for s in cow_slots])
                self.n_cow += len(cow_slots)
            borrowed = {s: int(matched[s]) for s in range(n_borrow)}
            self.prefix_hits += 1
            self.prefix_matched_tokens += suffix_start
        else:
            suffix_start = 0
            fresh = self._alloc(used)
            block_ids[:used] = fresh
        self._tables[row] = block_ids
        self.cache["lens"][row] = suffix_start
        self._set_device_tables()
        self._row_blocks[row] = list(fresh)
        self._row_borrowed[row] = borrowed
        self._row_used[row] = used
        self._worst[row] = worst + head    # reserve the registration copies
        self._head_reserved[row] = head
        self._outstanding += self._row_debt(row)
        self._note_peaks()
        return suffix_start

    def _write_span(self, slot):
        """Inclusive logical block range ``[lo, hi]`` the next round's
        writes may touch: the prefill chunk while the cursor is live,
        else the decode quantum; ``None`` if the round writes nothing."""
        bs = self.block_size
        if slot.cursor is not None:
            n = min(self.chunk_size, len(slot.req.prompt) - slot.cursor)
            if n <= 0:
                return None
            return slot.cursor // bs, (slot.cursor + n - 1) // bs
        lo = slot.lens
        return lo // bs, (lo + self.chunk_size - 1) // bs

    def _cow_window_rows(self) -> bool:
        """Window lane under prefix caching: the ring recycles blocks in
        place, so the next round may write into a shared block (borrowed,
        or this row's own registered prefix).  Copy each such block and
        swap the table entry first; admission reserved every copy."""
        src, dst = [], []
        w = self.table_width
        for i, slot in enumerate(self._slots):
            if slot is None or slot.done:
                continue
            span = self._write_span(slot)
            if span is None:
                continue
            lo, hi = span
            for q in range(lo, hi + 1):
                s = q % w
                bid = int(self._tables[i, s])
                if bid == self.n_blocks or self.pool.refcount(bid) <= 1:
                    continue
                nid, = self._take_blocks(1)
                src.append(bid)
                dst.append(nid)
                self._tables[i, s] = nid
                self._row_blocks[i].append(nid)
                self._outstanding -= 1
                if self._row_borrowed[i].pop(s, None) is None:
                    # own registered block: the index keeps the original
                    self._row_blocks[i].remove(bid)
                self.pool.release([bid])
                self.n_cow += 1
        if src:
            self.cache = self.engine.copy_blocks(self.cache, src, dst)
            return True
        return False

    def _ensure_blocks(self):
        """Extend each live decoding dense row's table to cover the next
        round's writes (window rows recycle their ring in place; prompt
        blocks were allocated whole at admission), then copy shared ring
        blocks the window lane would overwrite."""
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
                ids = self._alloc(need - have)
                self._tables[i, have:need] = ids
                self._row_blocks[i].extend(ids)
                self._row_used[i] = need
                self._outstanding -= len(ids)
                changed = True
        if self.prefix_cache and self.engine.window_lane:
            changed |= self._cow_window_rows()
        if changed:
            self._set_device_tables()

    def _sanitize_check_chunk(self):
        """Pre-round sanitizer gate: every resident table entry of a live
        row is still allocated (``check_read``) and every block the round
        writes through is exclusively owned (``check_write``)."""
        w = self.table_width
        for i, slot in enumerate(self._slots):
            if slot is None or slot.done:
                continue
            row = self._tables[i]
            self.pool.check_read(
                int(b) for b in row if int(b) != self.n_blocks)
            span = self._write_span(slot)
            if span is None:
                continue
            lo, hi = span
            if self.engine.window_lane:
                touched = {q % w for q in range(lo, hi + 1)}
            else:
                touched = range(lo, min(hi, w - 1) + 1)
            self.pool.check_write(
                int(row[s]) for s in touched if int(row[s]) != self.n_blocks)

    # ------------------------------------------------------------------
    # policy: EDF ordering and preemption
    # ------------------------------------------------------------------

    def _order_queue(self):
        """Earliest-deadline-first, stable (FIFO among equal deadlines and
        deadline-less requests); a no-op when no request has one."""
        if any(r.deadline is not None for r in self._queue):
            self._queue = deque(sorted(self._queue, key=_deadline_key))

    def _drop_row(self, i: int) -> list:
        """Drop every block reference row ``i`` holds and reset its host
        bookkeeping; returns the ids physically reclaimed."""
        self._outstanding -= self._row_debt(i)
        reclaimed = self.pool.free(self._row_blocks[i])
        if self._row_borrowed[i]:
            reclaimed += self.pool.release(
                list(self._row_borrowed[i].values()))
        self._row_blocks[i] = []
        self._row_borrowed[i] = {}
        self._row_used[i] = 0
        self._worst[i] = 0
        self._head_reserved[i] = 0
        self._tables[i] = self.n_blocks          # sentinel
        return reclaimed

    def _release_rows(self, mask, reclaimed):
        """Device half of retirement or preemption: ``lens -> 0`` and
        sentinel tables for ``mask``'s rows; under the sanitizer,
        poison the reclaimed blocks and refresh the leak gauge."""
        self.cache = kvc.paged_release_rows(
            self.cache, torch.as_tensor(mask, device=self.engine.device))
        if self.sanitize:
            if reclaimed:
                self.cache = self.engine.poison_blocks(self.cache, reclaimed)
            self.n_leaked = len(self.leak_report())

    def _preempt_row(self, i: int):
        """Evict live row ``i`` and requeue its request from scratch
        (already emitted tokens are discarded)."""
        slot = self._slots[i]
        self._slots[i] = None
        self.n_preempted += 1
        mask = np.zeros((self.n_slots,), bool)
        mask[i] = True
        self._release_rows(mask, self._drop_row(i))
        self._queue.append(slot.req)   # original arrival and deadline

    def _try_preempt(self, req: Request) -> bool:
        """Preempt the active row with the latest deadline, if strictly
        later than ``req``'s (best-effort counts as latest); paged modes
        only."""
        if not self.paged:
            return False
        victim, vd_max = None, _deadline_key(req)
        for i, s in enumerate(self._slots):
            if s is None or s.done:
                continue
            vd = _deadline_key(s.req)
            if vd > vd_max:
                victim, vd_max = i, vd
        if victim is None:
            return False
        self._preempt_row(victim)
        return True

    def _admit(self):
        self._order_queue()
        free = [i for i, s in enumerate(self._slots) if s is None]
        while self._queue and free:
            req = self._queue[0]
            row = free[0]
            if not self.paged:
                got = self._admit_dense(req, row)
            elif self.chunked:
                got = self._admit_chunked(req, row)
            else:
                got = self._admit_paged(req, row)
            if got is None:            # the pool cannot cover it yet
                if self._try_preempt(req):
                    self._order_queue()
                    free = [i for i, s in enumerate(self._slots) if s is None]
                    continue
                break                  # EDF: do not admit around the head
            self._queue.popleft()
            free.remove(row)
            self.n_admitted += 1
            if self.chunked:           # got: the chunk cursor
                self._slots[row] = _Slot(req=req, emitted=[],
                                         admitted_step=self.steps_run,
                                         cursor=got)
                continue
            # got: the first token, from the whole-prompt prefill; a
            # request can finish on it
            self._slots[row] = _Slot(
                req=req, emitted=[got], admitted_step=self.steps_run,
                done=got == req.eos_id or req.max_new_tokens == 1)
            self._cur_tok[row] = got

    def leak_report(self) -> set:
        """Allocated block ids unreachable from any live row's owned or
        borrowed entries or from the prefix index: references dropped
        without ``free``/``release``.  Empty on a healthy run (and in
        dense-cache mode, which has no pool)."""
        if not self.paged:
            return set()
        held: set = set()
        for ids in self._row_blocks:
            held.update(int(b) for b in ids)
        for borrowed in self._row_borrowed:
            held.update(int(b) for b in borrowed.values())
        if self.prefix_cache:
            held.update(int(b) for b in self.index.blocks_lru())
        return set(self.pool.allocated_ids()) - held

    def _retire(self):
        done_mask = np.zeros((self.n_slots,), bool)
        completions = []
        reclaimed: list = []
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
            if self.paged:
                reclaimed += self._drop_row(i)
        if done_mask.any():
            if self.paged:
                self._release_rows(done_mask, reclaimed)
            else:
                self.cache = kvc.reset_slots(self.cache, done_mask)
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
        if self.sanitize:
            self._sanitize_check_chunk()
        write_tables = None
        if any(self._row_borrowed):
            # borrowed entries take no write, not even a byte-identical one
            write_tables = self._tables.copy()
            for i, borrowed in enumerate(self._row_borrowed):
                for s in borrowed:
                    write_tables[i, s] = self.n_blocks
        self.cache, chunk_logits, toks = self.engine.mixed_step(
            self.cache, chunk, nv, self._cur_tok, self.chunk_size,
            decode_active=decode_active, write_tables=write_tables)
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
                    if self.prefix_cache:
                        self._register_row(req.prompt, i)
                        self._note_peaks()
                    tok0 = self._first_token(chunk_logits[i:i + 1])
                    s.emitted.append(tok0)
                    self._cur_tok[i] = tok0
                    if tok0 == req.eos_id or req.max_new_tokens == 1:
                        s.done = True
        return self._retire()

    def _step_unchunked(self):
        """Admit (a whole-prompt prefill each) -> extend live rows' tables
        (paged) or pull the shared frontier back if the quantum would not
        fit (dense) -> ONE decode quantum for the live rows -> emit their
        tokens -> retire."""
        self._admit()
        active = np.array([s is not None and not s.done for s in self._slots],
                          bool)
        if not active.any():
            # admissions can finish at once (EOS on the prefill token)
            return self._retire()
        if self.paged:
            self._ensure_blocks()
            if self.sanitize:
                self._sanitize_check_chunk()
        elif self._frontier + self.chunk_size > self.engine.max_len:
            # reclaim headroom freed by retirements and short rows
            self._set_frontier(max(s.lens for s in self._slots
                                   if s is not None and not s.done))
        self.cache, toks = self.engine.decode_chunk(
            self.cache, self._cur_tok, self.chunk_size, active=active)
        toks = toks.cpu().numpy()
        if not self.paged:
            self._frontier += self.chunk_size      # mirror of cache["len"]
        self.steps_run += self.chunk_size
        self.n_chunks += 1
        for i in np.nonzero(active)[0]:
            slot = self._slots[i]
            for t in toks[i]:
                slot.emitted.append(int(t))
                if int(t) == slot.req.eos_id or \
                        len(slot.emitted) >= slot.req.max_new_tokens:
                    slot.done = True
                    break
            self._cur_tok[i] = toks[i, -1]
        return self._retire()

    def step(self):
        """One scheduling round (wall-timed); returns the requests
        completed in it."""
        t0 = time.perf_counter()
        try:
            if self.chunked:
                return self._step_chunked()
            return self._step_unchunked()
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
