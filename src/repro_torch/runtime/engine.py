"""Serving engine over the paged posit KV cache (chunked-prefill lane).

The port of ``repro/runtime/engine.py``'s paged mode: the engine owns the
model, the block-table geometry and the sampler, and serves chunked
prefill through :meth:`Engine.mixed_step` -- one prefill chunk for every
row followed by ``n_steps`` masked decode steps, keyed
``("mixed", C, n_steps)`` and never by a prompt length.  PyTorch runs
eagerly, so there is no compiled program per key; ``n_compiles`` counts
the distinct dispatch keys the engine has served, which keeps the
reference's "flat across prompt lengths" invariant testable.

Usage::

    from repro_torch.runtime.engine import Engine
    eng = Engine(cfg, params, max_len=256, block_size=16,
                 decode_kernel="fused")            # device="cuda"
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.compress import kvcache as kvc
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def sample_token(logits, gen: torch.Generator, temperature: float):
    """(B, V) f32 logits -> (B,) int64 tokens.  ``temperature`` 0 is
    greedy argmax (first maximum on ties, consumes no randomness); > 0
    samples from the softmax at that temperature using ``gen``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


class Engine:
    """Batched paged serving engine for the transformer family."""

    def __init__(self, cfg: ModelConfig, params, *, max_len: int,
                 temperature: float = 0.0, seed: int = 0, pad_id: int = 0,
                 block_size: int = 16, n_blocks: int = 0,
                 sanitize: bool = False, decode_kernel: str = None,
                 device="cuda"):
        """``n_blocks`` sizes the shared arena (0 = one full table per
        row).  ``sanitize=True`` arms the arena sanitizer: the
        scheduler's pool checks double frees, use-after-free and writes
        into shared blocks, and reclaimed blocks are poisoned on the
        device (:meth:`poison_blocks`).  ``decode_kernel`` picks the
        paged decode attention: ``'gather'`` (plain torch) or ``'fused'``
        (the CUDA table-walk kernels); it threads through
        ``cfg.paged_attn_kernel``.  ``params`` must already live on
        ``device``."""
        self.device = resolve_device(device)
        if decode_kernel is not None:
            if decode_kernel not in ("gather", "fused"):
                raise ValueError(
                    f"decode_kernel must be 'gather' or 'fused', got "
                    f"{decode_kernel!r}")
            cfg = dataclasses.replace(cfg, paged_attn_kernel=decode_kernel)
        if cfg.family != "transformer":
            raise ValueError(
                "paged KV caches need the transformer family's per-row "
                f"decode positions (got {cfg.family!r})")
        T._require_dense(cfg)
        if int(block_size) < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if params["tok_embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['tok_embed'].device}, engine "
                f"device is {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_len = int(max_len)
        self.temperature = float(temperature)
        self.pad_id = int(pad_id)
        self.block_size = int(block_size)
        self.n_blocks = int(n_blocks)
        self.sanitize = bool(sanitize)
        self.table_width = T.paged_table_width(cfg, self.block_size,
                                               self.max_len)
        self.window_lane = L.paged_is_window_lane(
            T._paged_window(cfg), self.block_size, self.table_width)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self._dispatch_keys: set = set()

    @property
    def n_compiles(self) -> int:
        """Distinct dispatch keys served (``("mixed", C, n_steps)``, and
        ``("copy", n)``/``("poison", n)`` per block count): the port's
        counterpart of the reference's compiled-program count, flat
        across prompt lengths in chunked mode."""
        return len(self._dispatch_keys)

    def init_cache(self, n_slots: int):
        """Empty paged pool cache for ``n_slots`` rows on the engine's
        device."""
        return T.init_paged_cache(
            self.cfg, n_slots, self.max_len, self.block_size,
            self.n_blocks or n_slots * self.table_width, device=self.device)

    def _row_blocks_needed(self, prompt_len: int, reserve: int) -> int:
        """Blocks covering a row's prompt plus ``reserve`` decode writes
        (window rows hold the full bounded ring)."""
        if self.window_lane:
            return self.table_width
        need = min(prompt_len + reserve, self.max_len)
        return -(-need // self.block_size)

    def _alloc_tables(self, lens, reserve: int, n_blocks: int, pool=None):
        """Host-side block allocation for a prompt batch: the (B, W) int32
        table (sentinel ``n_blocks`` in unassigned entries) and the pool
        it drew from."""
        pool = pool or kvc.BlockPool(n_blocks)
        tables = np.full((len(lens), self.table_width), n_blocks, np.int32)
        for row, plen in enumerate(lens):
            need = self._row_blocks_needed(int(plen), reserve)
            tables[row, :need] = pool.alloc(need)
        return tables, pool

    def mixed_step(self, cache, chunk_tokens, n_valid, tokens, n_steps: int,
                   *, decode_active=None, write_tables=None):
        """Advance prefilling and decoding rows in one dispatch.

        Phase 1 runs ``prefill_chunk``: row ``b`` appends
        ``chunk_tokens[b, :n_valid[b]]`` at positions ``lens[b] ..``.
        Phase 2 runs ``n_steps`` masked decode steps for the rows with
        ``decode_active`` set, fed by ``tokens`` (the last sampled token
        per row).  A phase with no participating row is skipped: its
        outputs (the chunk logits, the sampled tokens) would only be read
        for participating rows.  ``write_tables`` (B, W), when given,
        replaces the block tables for the prefill chunk's arena write
        (borrowed prefix entries set to the sentinel).

        Returns ``(cache, chunk_logits (B, V), toks (B, n_steps))`` as
        device tensors; ``chunk_logits[b]`` is taken at row ``b``'s last
        valid chunk position.
        """
        dev = self.device
        chunk_tokens = torch.as_tensor(np.asarray(chunk_tokens),
                                       dtype=torch.int64, device=dev)
        b, c = chunk_tokens.shape
        nv = np.asarray(n_valid, np.int32)
        act = np.zeros((b,), bool) if decode_active is None \
            else np.asarray(decode_active, bool)
        lens_np = cache["lens"].cpu().numpy()
        if (nv > 0).any():
            hi = int((lens_np + nv)[nv > 0].max())
            if hi > self.max_len:
                raise ValueError(
                    f"mixed_step: prefill chunk frontier {hi} exceeds "
                    f"engine max_len {self.max_len}")
        if act.any():
            hi = int(lens_np[act].max())
            if hi + int(n_steps) > self.max_len:
                raise ValueError(
                    f"mixed_step: decode frontier {hi} + {int(n_steps)} "
                    f"steps exceeds engine max_len {self.max_len}; retire "
                    "rows first")
        self._dispatch_keys.add(("mixed", int(c), int(n_steps)))
        vw = -(-self.max_len // self.block_size)
        chunk_logits = torch.zeros((b, self.cfg.vocab), dtype=torch.float32,
                                   device=dev)
        if (nv > 0).any():
            cache, chunk_logits = T.prefill_chunk(
                self.params, cache, chunk_tokens, self.cfg,
                torch.as_tensor(nv, device=dev), virtual_width=vw,
                write_tables=write_tables)
        toks = torch.zeros((b, int(n_steps)), dtype=torch.int64, device=dev)
        if act.any():
            tok = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                                  device=dev)
            active = torch.as_tensor(act, device=dev)
            for i in range(int(n_steps)):
                logits, cache = T._decode_step_paged(
                    self.params, cache, tok, self.cfg, active)
                tok = sample_token(logits, self.gen, self.temperature)
                toks[:, i] = tok
        return cache, chunk_logits, toks

    # ------------------------------------------------------------------
    # prefix sharing: COW block copies and sanitizer poison
    # ------------------------------------------------------------------

    def copy_blocks(self, cache, src_ids, dst_ids):
        """Copy-on-write, device half: duplicate arena blocks
        ``src_ids -> dst_ids`` in place across every arena leaf and
        layer (posit patterns move verbatim, no dequantize round trip).
        Returns ``cache``."""
        self._dispatch_keys.add(("copy", len(src_ids)))
        for key in kvc.arena_leaves(cache):
            L.paged_copy_blocks(cache[key], src_ids, dst_ids)
        return cache

    def poison_blocks(self, cache, ids):
        """Sanitizer, device half: overwrite reclaimed arena blocks in
        place with the loud but finite poison of
        ``layers.paged_poison_blocks`` across every arena leaf and layer,
        so a stale table entry corrupts logits visibly instead of
        silently serving freed KV.  Returns ``cache``."""
        if not ids:
            return cache
        self._dispatch_keys.add(("poison", len(ids)))
        for key in kvc.arena_leaves(cache):
            L.paged_poison_blocks(cache[key], ids)
        return cache
