"""Serving engine: preallocated posit KV caches, the one-shot generate and
the decode quantum of the continuous-batching scheduler.

The port of ``repro/runtime/engine.py``.  The engine owns the model (any
family of ``models.registry``: the transformer, hymba, rwkv6, whisper),
the cache geometry and the sampler:

* every cache is preallocated to ``max_len`` up front (posit patterns
  when ``cfg.kv_posit`` is set) and a request that would not fit is
  refused before any work (``_check_fits``) -- decode never writes past
  the capacity;
* sliding-window caches run as rings (capacity = window, writes at
  ``pos % window``);
* ragged prompt batches (transformer family only) are left-padded to a
  common length; each row carries its own length, RoPE positions and
  masks;
* encoder ``frames`` (whisper) and ``visual`` patch embeddings
  (internvl) go to the family's prefill; decode runs off the cache;
* sampling is greedy or at a temperature, batched, from one
  ``torch.Generator``;
* ``paged=True`` (transformer family only) swaps the linear
  ``batch x max_len`` cache for the block-table layout (rows take arena
  blocks from a host-side ``kvcache.BlockPool``), with token streams
  identical to the linear layout's; a paged engine also serves chunked
  prefill through :meth:`Engine.mixed_step` (one prefill chunk for every
  row, then ``n_steps`` masked decode steps);
* ``mesh=`` (a ``("data", "model")`` ``DeviceMesh`` from
  ``launch.mesh``) serves tensor-parallel in every mode and family:
  each rank keeps its shard of the weights (``runtime/sharding.py``),
  its heads' share of the cache (``sharding.cache_split_leaves``) and
  the rank-local config, and the forward adds the collectives GSPMD
  inserts in the reference (``runtime/collectives.py``); token streams
  are the single device's.

PyTorch runs eagerly: the reference's one ``lax.scan`` per generation
is a loop of decode steps here, and ``n_compiles`` counts the dispatch
keys of the programs the reference would compile -- one prefill per
(ragged, extra inputs, batch, padded prompt length), one generate per
(tokens, batch), one decode quantum per (steps, batch), one mixed step
per (chunk width, steps) -- so its compile-count invariants stay
testable.

Usage::

    from repro_torch.runtime.engine import Engine
    eng = Engine(cfg, params, max_len=256)                 # device="cuda"
    res = eng.generate([[5, 3, 9], [7, 2, 4, 4, 1]], max_new_tokens=32)
    res.tokens          # (2, 32) int32
    res.prompt_lens     # [3, 5]
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.compress import kvcache as kvc
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_family
from repro_torch.runtime import sharding


def sample_token(logits, gen: torch.Generator, temperature: float):
    """(B, V) f32 logits -> (B,) int32 tokens, as the reference's.
    ``temperature`` 0 is greedy argmax (first maximum on ties, consumes
    no randomness); > 0 samples from the softmax at that temperature
    using ``gen``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, max_new_tokens) int32
    prompt_lens: np.ndarray     # (B,) int32 per-row prompt lengths
    prefill_logits: np.ndarray  # (B, V) f32 logits after the prompt
    cache: Any                  # the final cache dict


class Engine:
    """Batched serving engine for every model family."""

    def __init__(self, cfg: ModelConfig, params, *, max_len: int,
                 temperature: float = 0.0, seed: int = 0, pad_id: int = 0,
                 paged: bool = False, block_size: int = 16, n_blocks: int = 0,
                 sanitize: bool = False, decode_kernel: str = None,
                 device="cuda", mesh=None):
        """``paged=True`` takes the block-table layout: prefill allocates
        arena blocks per row from a ``BlockPool`` instead of reserving
        ``batch x max_len`` slots.  ``n_blocks`` sizes the shared arena
        (0 = one full table per row).  ``sanitize=True`` arms the arena
        sanitizer: the scheduler's pool checks double frees,
        use-after-free and writes into shared blocks, and reclaimed
        blocks are poisoned on the device (:meth:`poison_blocks`).
        ``decode_kernel`` picks the paged decode attention (paged
        engines only): ``'gather'`` (plain torch) or ``'fused'`` (the
        CUDA table-walk kernels); it threads through
        ``cfg.paged_attn_kernel``.  ``params`` must already live on
        ``device``.

        ``mesh`` (a ``DeviceMesh`` with a ``"model"`` axis, e.g.
        ``launch.mesh.make_host_mesh``) serves tensor-parallel: the
        weights are cut to this rank's shard by the rule table (leaves
        already at their local shape stay), ``self.cfg`` becomes the
        rank-local config (this rank's heads and ``d_ff``), caches hold
        this rank's KV heads and recurrent-state heads (:meth:`init_cache`,
        :meth:`cache_shards`) and every model call carries the plan
        ``self.tp``.  Any family, paged or linear; without a mesh, or
        with a ``"model"`` axis of size 1, nothing changes.  Where the
        config's ``seq_shard_activations`` is set and the transformer's
        attention heads do not split, prefill attention is
        context-parallel (``sharding.context_parallel_prefill``)."""
        self.device = resolve_device(device)
        if decode_kernel is not None:
            if decode_kernel not in ("gather", "fused"):
                raise ValueError(
                    f"decode_kernel must be 'gather' or 'fused', got "
                    f"{decode_kernel!r}")
            if not paged:
                raise ValueError(
                    "decode_kernel selects the PAGED decode attention "
                    "path; construct the engine with paged=True")
            cfg = dataclasses.replace(cfg, paged_attn_kernel=decode_kernel)
        self.fam = get_family(cfg)
        if params["tok_embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['tok_embed'].device}, engine "
                f"device is {self.device}")
        self.mesh = mesh
        self.tp = sharding.tensor_parallel(cfg, mesh, serve=True)
        self.cfg = sharding.local_config(cfg, self.tp)
        self.params = sharding.shard_params(params, mesh, cfg)
        self.max_len = int(max_len)
        self.temperature = float(temperature)
        self.pad_id = int(pad_id)
        self.paged = bool(paged)
        self.block_size = int(block_size)
        self.n_blocks = int(n_blocks)
        self.sanitize = bool(sanitize)
        # families whose decode step takes the scheduler's ``active`` mask
        self.masked = cfg.family in ("transformer", "hymba")
        if self.paged:
            if cfg.family != "transformer":
                raise ValueError(
                    "paged KV caches need the transformer family's "
                    f"per-row decode positions (got {cfg.family!r})")
            if self.block_size < 1:
                raise ValueError(f"block_size must be >= 1, got {block_size}")
            self.table_width = T.paged_table_width(cfg, self.block_size,
                                                   self.max_len)
            self.window_lane = L.paged_is_window_lane(
                T._paged_window(cfg), self.block_size, self.table_width)
        self.pool = None               # BlockPool of the last paged prefill
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self._dispatch_keys: set = set()

    @property
    def n_compiles(self) -> int:
        """Distinct dispatch keys served: the port's counterpart of the
        reference's compiled-program count (per-shape prefill retraces
        included), flat across prompt lengths in chunked mode."""
        return len(self._dispatch_keys)

    def init_cache(self, n_slots: int):
        """Empty cache for ``n_slots`` rows on the engine's device: the
        paged pool cache, or the family's linear cache of ``max_len``.
        Under a mesh, only this rank's share: the rank-local config's KV
        and state heads (all of them where they do not split, and the MLA
        latents whole), never the whole cache."""
        if not self.paged:
            return self.fam.init_cache(self.cfg, n_slots, self.max_len,
                                       device=self.device)
        return T.init_paged_cache(
            self.cfg, n_slots, self.max_len, self.block_size,
            self.n_blocks or n_slots * self.table_width, device=self.device)

    def cache_shards(self) -> dict:
        """``{leaf: ranks it is split over}`` of this engine's caches
        (``kvcache.cache_report``'s ``shards``): the K/V leaves where the
        KV heads split, the recurrent state where the heads split
        (``sharding.cache_split_leaves``), nothing on one device."""
        return {k: self.tp.size
                for k in sharding.cache_split_leaves(self.cfg.family, self.tp)}

    def sample(self, logits):
        """(B, V) f32 logits -> (B,) int32 tokens (:func:`sample_token`
        with the engine's generator and temperature).  Under a mesh,
        sampling at a temperature takes rank 0's draw on every rank;
        greedy tokens are the argmax of logits every rank holds whole."""
        tok = sample_token(logits, self.gen, self.temperature)
        if self.tp is not None and self.temperature > 0.0:
            tok = self.tp.broadcast(tok)
        return tok

    # ------------------------------------------------------------------
    # prompt packing and prefill
    # ------------------------------------------------------------------

    def pack_prompts(self, prompts):
        """A list of token lists (or a 2-D array) -> left-padded (B, S)
        int32 tokens and (B,) int32 lengths, on the host."""
        if isinstance(prompts, (np.ndarray, torch.Tensor)) and prompts.ndim == 2:
            tokens = np.asarray(prompts, np.int32)
            return tokens, np.full((tokens.shape[0],), tokens.shape[1], np.int32)
        lens = np.asarray([len(p) for p in prompts], np.int32)
        tokens = np.full((len(prompts), int(lens.max())), self.pad_id, np.int32)
        for i, p in enumerate(prompts):                       # left-pad
            tokens[i, tokens.shape[1] - len(p):] = np.asarray(p, np.int32)
        return tokens, lens

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
        pool = pool or kvc.BlockPool(n_blocks, sanitize=self.sanitize)
        tables = np.full((len(lens), self.table_width), n_blocks, np.int32)
        for row, plen in enumerate(lens):
            need = self._row_blocks_needed(int(plen), reserve)
            tables[row, :need] = pool.alloc(need)
        return tables, pool

    def prefill(self, prompts, *, frames=None, visual=None,
                reserve_tokens: int = 0, paged=None):
        """Run a (possibly ragged) prompt batch whole; returns ``(cache,
        last-position logits (B, V) f32, lens (B,) numpy)``.

        On a paged engine each row gets arena blocks for its prompt plus
        ``reserve_tokens`` decode writes (``generate`` reserves its whole
        budget); ``paged=False`` forces the linear layout (the unchunked
        paged scheduler prefills rows linearly and packs them into its
        pool itself)."""
        use_paged = self.paged if paged is None else bool(paged)
        if use_paged and not self.paged:
            raise ValueError(
                "prefill(paged=True) needs an engine constructed with "
                "Engine(..., paged=True): only that sizes the block tables "
                "and arena")
        tokens, lens = self.pack_prompts(prompts)
        b, s = tokens.shape
        if s > self.max_len:
            raise ValueError(f"padded prompt length {s} exceeds engine max_len "
                             f"{self.max_len}")
        ragged = bool((lens != lens[0]).any())
        if ragged and self.cfg.family != "transformer":
            raise ValueError(
                "ragged prompt batches are only supported for the "
                f"transformer family (got family={self.cfg.family!r}); "
                "pad or bucket the prompts")
        if ragged and visual is not None:
            raise ValueError(
                "ragged prompt batches cannot carry a visual prefix: patch "
                "embeddings are prepended at the sequence front, which is "
                "where left-padding lives; pad the prompts to a common "
                "length instead")
        dev = self.device
        kw = {k: torch.as_tensor(v, device=dev)
              for k, v in (("frames", frames), ("visual", visual)) if v is not None}
        key = ("prefill", ragged, tuple(sorted(kw)))
        nb = 0
        if use_paged:
            nb = self.n_blocks or b * self.table_width
            tables, self.pool = self._alloc_tables(lens, int(reserve_tokens), nb)
            kw.update(block_tables=tables, block_size=self.block_size, n_blocks=nb)
        if ragged:
            kw["prompt_lens"] = torch.as_tensor(lens, device=dev)
        if self.tp is not None:
            kw["tp"] = self.tp
        self._dispatch_keys.add(key + (nb, b, s))
        cache, logits = self.fam.prefill(
            self.params, torch.as_tensor(tokens, dtype=torch.int64, device=dev),
            self.cfg, max_len=self.max_len, **kw)
        return cache, logits, lens

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _step(self, cache, tok, active=None):
        """One decode step of the family; the transformer's without the
        eager capacity check (callers checked the whole quantum up front,
        as the reference's traced scan relies on).  ``active`` reaches
        only the families that take it (``masked``)."""
        if self.cfg.family == "transformer":
            step = T._decode_step_paged if "block_tables" in cache else T._decode_step_linear
            return step(self.params, cache, tok, self.cfg, active, tp=self.tp)
        if self.masked:
            return self.fam.decode_step(self.params, cache, tok, self.cfg,
                                        active=active, tp=self.tp)
        return self.fam.decode_step(self.params, cache, tok, self.cfg, tp=self.tp)

    def decode_chunk(self, cache, tokens, n_steps: int, *, active=None):
        """Advance every row by ``n_steps`` decode steps; returns
        ``(cache, (B, n_steps) int64 sampled tokens)`` on the device.

        ``tokens`` (B,): the last sampled token per row.  ``active`` (B,)
        bool: inactive rows run through the batch, their ``lens`` stay
        frozen and their tokens are garbage the scheduler discards.
        Raises if the quantum would run the write frontier past
        ``max_len`` (callers compact or retire rows first)."""
        b = len(tokens)
        act = np.ones((b,), bool) if active is None else np.asarray(active, bool)
        if "block_tables" in cache:
            if act.any():
                hi = int(cache["lens"].cpu().numpy()[act].max())
                if hi + int(n_steps) > self.max_len:
                    raise ValueError(
                        f"decode_chunk: paged row frontier {hi} + {int(n_steps)} "
                        f"steps exceeds engine max_len {self.max_len}; retire "
                        "rows first")
        elif int(cache["len"]) + int(n_steps) > self.max_len:
            raise ValueError(
                f"decode_chunk: frontier {int(cache['len'])} + {int(n_steps)} "
                f"steps exceeds engine max_len {self.max_len}; compact the "
                "cache (kvcache.compact) or retire rows first")
        self._dispatch_keys.add(("chunk", int(n_steps), b))
        dev = self.device
        tok = torch.as_tensor(np.asarray(tokens), dtype=torch.int64, device=dev)
        active_t = torch.as_tensor(act, device=dev)
        toks = torch.zeros((b, int(n_steps)), dtype=torch.int64, device=dev)
        for i in range(int(n_steps)):
            logits, cache = self._step(cache, tok, active_t)
            tok = self.sample(logits)
            toks[:, i] = tok
        return cache, toks

    def _check_fits(self, padded_len: int, max_new_tokens: int):
        need = padded_len + max_new_tokens - 1        # last token not cached
        if need > self.max_len:
            raise ValueError(
                f"prompt ({padded_len}) + {max_new_tokens} new tokens needs "
                f"{need} cache slots > engine max_len {self.max_len}")

    def _generate(self, prompts, max_new_tokens: int, stepwise: bool, frames,
                  visual):
        tokens, _ = self.pack_prompts(prompts)
        self._check_fits(tokens.shape[1], max_new_tokens)
        cache, logits, lens = self.prefill(prompts, frames=frames, visual=visual,
                                           reserve_tokens=max_new_tokens - 1)
        b = tokens.shape[0]
        self._dispatch_keys.add(("step", b) if stepwise
                                else ("generate", int(max_new_tokens), b))
        tok = self.sample(logits)
        out = [tok]
        for _ in range(max_new_tokens - 1):
            if stepwise:
                step_logits, cache = self.fam.decode_step(self.params, cache, tok,
                                                          self.cfg, tp=self.tp)
            else:
                step_logits, cache = self._step(cache, tok)
            tok = self.sample(step_logits)
            out.append(tok)
        return GenerationResult(
            tokens=torch.stack(out, dim=1).cpu().numpy().astype(np.int32),
            prompt_lens=np.asarray(lens), prefill_logits=logits.cpu().numpy(),
            cache=cache)

    def generate(self, prompts, max_new_tokens: int, *, frames=None,
                 visual=None) -> GenerationResult:
        """Prefill, then ``max_new_tokens - 1`` decode steps after the
        first sampled token, checked against ``max_len`` once up front
        (the reference's one compiled scan).  Raises before any work if
        the request cannot fit."""
        return self._generate(prompts, max_new_tokens, False, frames, visual)

    def generate_stepwise(self, prompts, max_new_tokens: int, *, frames=None,
                          visual=None) -> GenerationResult:
        """The same sampling through the public ``decode_step`` (its eager
        capacity check every step); tokens identical to :meth:`generate`."""
        return self._generate(prompts, max_new_tokens, True, frames, visual)

    # ------------------------------------------------------------------
    # chunked prefill: prefill chunks and decode steps in one dispatch
    # ------------------------------------------------------------------

    def mixed_step(self, cache, chunk_tokens, n_valid, tokens, n_steps: int,
                   *, decode_active=None, write_tables=None):
        """Advance prefilling and decoding rows in one dispatch (paged
        engines only).

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
        if not self.paged:
            raise ValueError("mixed_step needs Engine(paged=True)")
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
                write_tables=write_tables, tp=self.tp)
        toks = torch.zeros((b, int(n_steps)), dtype=torch.int64, device=dev)
        if act.any():
            tok = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                                  device=dev)
            active = torch.as_tensor(act, device=dev)
            for i in range(int(n_steps)):
                logits, cache = T._decode_step_paged(
                    self.params, cache, tok, self.cfg, active, tp=self.tp)
                tok = self.sample(logits)
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
