"""KV-cache memory model: the paged layout's host-side block pool, prefix
index and row release; the linear layout's slot-pool surgery
(``reset_slots``, ``compact``, ``adopt_row``) and the graft of a linear
prefill into the arena (``paged_adopt_row``); the cache codec
(``quantize_cache``, ``dequantize_cache``), byte counts and report; and
posit-domain cache maintenance (``scale_cache``, ``merge_caches``) on the
fused elementwise kernel.

Paged layout (see ``models/transformer.py``): arena content leaves are
(L, n_blocks, block_size, ...), one pool of blocks shared by every batch
row; ``block_tables`` (B, W) int32 names each row's physical blocks, with
the out-of-range sentinel ``n_blocks`` in unassigned entries (writes
through it are dropped, reads through it clamp and are masked).  The
:class:`BlockPool` is host state; block ids reach the device only inside
``block_tables``.  Linear layout: (L, B, T, ...) leaves, the shared
write frontier ``len`` and ``max_len`` as Python ints, per-row ``lens``.

Caches are plain dicts, so the leaf name is the tag: content leaves
(K/V, posit patterns or floats) are listed in ``CONTENT_LEAVES`` and
bookkeeping in ``META_LEAVES``; unknown leaves raise instead of being
guessed from their dtype.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from repro_torch.core.types import signed_view
from repro_torch.kernels import ops as kops
from repro_torch.kernels import posit_codec
from .gradient import pcfg_of, scalar_pattern

# Time-axis content (the surgery's move set), per-row state without a
# time axis (zeroed on reset, grafted on adopt), all content, and
# bookkeeping (the reference's schema).
_TIME_LEAVES = frozenset(
    {"k", "v", "c_kv", "k_rope", "k_swa", "v_swa", "k_glb", "v_glb"})
_ROW_LEAVES = frozenset({"ssm"})
CONTENT_LEAVES = _TIME_LEAVES | _ROW_LEAVES | frozenset(
    {"ck", "cv", "wkv", "tm_x", "cm_x"})
META_LEAVES = frozenset(
    {"len", "lens", "max_len", "length", "block_tables"})


def _leaf_bytes(key, x):
    """(actual bytes, f32-equivalent bytes) of one cache leaf."""
    if key not in CONTENT_LEAVES and key not in META_LEAVES:
        raise ValueError(
            f"unknown cache leaf {key!r}: register it in "
            "kvcache.CONTENT_LEAVES or kvcache.META_LEAVES")
    if not isinstance(x, torch.Tensor):          # a Python int scalar
        return 4, 4
    actual = x.numel() * x.element_size()
    return actual, (x.numel() * 4 if key in CONTENT_LEAVES else actual)


def cache_report(cache, pool=None, shards=None) -> dict:
    """Actual vs f32-equivalent bytes and the compression ratio; with a
    ``pool``, also the physical/logical block counts and their peaks.
    Content leaves count 4 bytes per element in the f32 baseline,
    bookkeeping counts as stored (a Python-int ``max_len`` as int32).

    ``per_device_bytes`` is the footprint on one device: ``bytes`` on a
    single device.  Under tensor-parallel serving ``cache`` is one rank's
    and ``shards`` (``Engine.cache_shards``) maps each split leaf to the
    ranks it is split over: ``bytes`` then counts the whole cache, as the
    reference counts the global array, and ``per_device_bytes`` this
    rank's (the share of each head-sharded leaf -- a paged arena, a
    linear cache's K/V, a recurrent state -- plus every whole leaf and
    the metadata)."""
    shards = shards or {}
    actual = f32 = local = 0
    for key, x in cache.items():
        a, f = _leaf_bytes(key, x)
        n = shards.get(key, 1)
        actual += a * n
        f32 += f * n
        local += a
    out = {"bytes": actual, "f32_bytes": f32, "ratio": f32 / max(actual, 1),
           "per_device_bytes": local}
    if pool is not None:
        out.update(
            physical_blocks=pool.in_use,
            logical_blocks=pool.logical_in_use,
            peak_physical_blocks=pool.peak_in_use,
            peak_logical_blocks=pool.peak_logical)
    return out


def cache_bytes(cache) -> int:
    """Bytes the cache holds (a Python-int scalar leaf as int32)."""
    return sum(_leaf_bytes(key, x)[0] for key, x in cache.items())


def quantize_cache(cache, name: str):
    """Quantize every float content leaf to posit patterns (the codec's
    quantize); bookkeeping passes through.  An unregistered float leaf
    raises rather than being silently left uncompressed.  Returns a new
    dict."""
    cfg = pcfg_of(name)
    out = {}
    for key, x in cache.items():
        floating = isinstance(x, torch.Tensor) and x.is_floating_point()
        if floating and key in CONTENT_LEAVES:
            x = posit_codec.quantize(x.to(torch.float32).contiguous(), cfg)
        elif floating and key not in META_LEAVES:
            raise ValueError(
                f"unknown float cache leaf {key!r}: register it in "
                "kvcache.CONTENT_LEAVES (quantizable content) or "
                "kvcache.META_LEAVES (bookkeeping); refusing to silently "
                "skip it")
        out[key] = x
    return out


def dequantize_cache(cache, name: str):
    """Decode every posit-pattern content leaf to f32 (the codec's
    dequantize); returns a new dict."""
    cfg = pcfg_of(name)
    return {key: posit_codec.dequantize(x.contiguous(), cfg)
            if _leaf_is_patterns(key, x) else x for key, x in cache.items()}


def is_paged(cache) -> bool:
    return isinstance(cache, dict) and "block_tables" in cache


def _reject_paged(cache, what: str):
    if is_paged(cache):
        raise ValueError(
            f"{what}: paged (block-table) caches have no shared linear "
            "frontier to move; use paged_adopt_row / paged_release_rows "
            "and the BlockPool instead")


# ---------------------------------------------------------------------------
# Slot-pool surgery on linear (and ring) caches
#
# A linear cache carries ``len`` (the shared padded write frontier, a
# Python int), ``lens`` (B,) per-row valid counts and ``max_len``.  The
# scheduler treats the batch axis as a slot pool: retired rows are wiped
# (``reset_slots``), the frontier moves to reclaim headroom or fit a long
# prompt (``compact``), and a prefilled batch-1 cache is grafted into a
# free row (``adopt_row``).  Time leaves roll circularly, which is exact
# for linear caches (stale slots stay masked by ``lens``) and is the
# frontier relabelling of a ring (slot = pos % T).
# ---------------------------------------------------------------------------

def reset_slots(cache, rows):
    """Retire the batch rows where ``rows`` (B,) is True: their content
    (time leaves and per-row state) zeroed in place and ``lens`` set to
    0.  Returns a new dict."""
    from repro_torch.models import layers as L

    _reject_paged(cache, "reset_slots")
    rows = torch.as_tensor(rows).to(torch.bool)
    for key, leaf in cache.items():
        if key in _TIME_LEAVES or key in _ROW_LEAVES:
            L.reset_cache_rows(leaf, rows)
    lens = cache["lens"]
    return dict(cache, lens=torch.where(rows.to(lens.device), 0, lens).to(torch.int32))


def compact(cache, target_len=None):
    """Move the shared write frontier to ``target_len`` (default:
    ``max(lens)``), rolling every time leaf so each row's content still
    ends at the frontier.  ``lens`` and ``max_len`` are unchanged.
    Returns a new dict (the rolled leaves are new tensors).  A rank's
    share of a head-sharded cache compacts the same way: the roll is on
    the time axis, and every rank's ``lens`` and frontier are the same."""
    from repro_torch.models import layers as L

    _reject_paged(cache, "compact")
    target = int(cache["lens"].max()) if target_len is None else int(target_len)
    if target > int(cache["max_len"]):
        raise ValueError(f"compact: target frontier {target} exceeds cache "
                         f"max_len {int(cache['max_len'])}")
    shift = target - int(cache["len"])
    out = {key: L.roll_cache_time(leaf, shift) if key in _TIME_LEAVES else leaf
           for key, leaf in cache.items()}
    out["len"] = target
    return out


def adopt_row(cache, row_cache, row: int):
    """Graft a batch-1 prefilled linear cache into slot ``row``, in
    place: its time leaves rolled so the prompt ends at the pool's
    frontier (RoPE positions are content-relative, so relabelling padded
    slots is free), its per-row state copied, its ``lens`` into the row.
    The prompt's frontier must not pass the pool's (``compact`` first).
    Returns a new dict."""
    from repro_torch.models import layers as L

    _reject_paged(cache, "adopt_row")
    cur, src = int(cache["len"]), int(row_cache["len"])
    if src > cur:
        raise ValueError(
            f"adopt_row: admitted prompt frontier {src} exceeds the pool "
            f"frontier {cur}; compact(cache, target_len={src}) first")
    for key, leaf in cache.items():
        if key in _TIME_LEAVES and key in row_cache:
            upd = L.roll_cache_time(row_cache[key], cur - src)
            signed_view(leaf)[:, row] = signed_view(upd)[:, 0]
        elif key in _ROW_LEAVES and key in row_cache:
            signed_view(leaf)[:, row] = signed_view(row_cache[key])[:, 0]
    lens = cache["lens"].clone()
    lens[row] = row_cache["lens"][0]
    return dict(cache, lens=lens)


def paged_adopt_row(cache, row_cache, row: int, block_ids, *, window: int = 0,
                    src_ring: bool = False):
    """Graft a batch-1 linear prefilled cache into row ``row`` of a
    paged pool cache, in place: its patterns are packed verbatim (no
    second quantize) into the arena blocks ``block_ids`` (W,) names
    (sentinel entries drop), and the row's table and ``lens`` take over.
    ``src_ring`` marks a ring-layout source (a window prefill longer than
    the window); out-of-window slots get the garbage the masks exclude,
    as in the ring itself.  Returns a new dict."""
    from repro_torch.models import layers as L

    if not is_paged(cache):
        raise ValueError("paged_adopt_row: pool cache is not paged "
                         "(no block_tables leaf)")
    dev = cache["lens"].device
    ids = torch.as_tensor(block_ids, device=dev).to(torch.int32)
    plen = row_cache["lens"][:1].to(device=dev, dtype=torch.int32)
    for key in arena_leaves(cache):
        if key in row_cache:
            L.paged_pack(cache[key], row_cache[key], ids[None], plen,
                         window=window, src_ring=src_ring)
    tables, lens = cache["block_tables"].clone(), cache["lens"].clone()
    tables[row] = ids
    lens[row] = plen[0]
    return dict(cache, block_tables=tables, lens=lens)


def arena_leaves(cache) -> list:
    """Names of a paged cache's arena content leaves (K/V or the MLA
    latents), in the cache's own order."""
    return [key for key in cache if key in _TIME_LEAVES]


class BlockSanitizerError(ValueError):
    """Arena-sanitizer violation: double free, use-after-free, a write
    into a shared (refcount > 1) block that skipped copy-on-write, or a
    wild block id."""


class BlockPool:
    """Host-side refcounted allocator over ``n_blocks`` arena block ids.

    ``alloc(n)`` hands out ``n`` physically free blocks at refcount 1
    (lowest ids first); ``share(ids)`` increments refcounts;
    ``free(ids)``/``release(ids)`` decrement and reclaim at zero, and
    dropping a reference that is not held raises.  ``in_use`` counts
    physical blocks, ``logical_in_use`` references; ``peak_*`` are their
    high-water marks.

    ``sanitize=True`` diagnoses misuse of freed ids as
    :class:`BlockSanitizerError` (use-after-free vs double free) and
    arms the ``check_write``/``check_read`` gates.
    """

    def __init__(self, n_blocks: int, *, sanitize: bool = False):
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        self.n_blocks = int(n_blocks)
        self._free = list(range(self.n_blocks - 1, -1, -1))  # pop() -> asc
        self._ref: dict = {}            # block id -> refcount (>= 1)
        self.peak_in_use = 0
        self.peak_logical = 0
        self.sanitize = bool(sanitize)
        self._freed: set = set()        # freed and not yet reallocated
        self.n_sanitizer_checks = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._ref)

    @property
    def logical_in_use(self) -> int:
        return sum(self._ref.values())

    def refcount(self, block_id: int) -> int:
        return self._ref.get(int(block_id), 0)

    def _note_peaks(self):
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        self.peak_logical = max(self.peak_logical, self.logical_in_use)

    def alloc(self, n: int) -> list:
        """Take ``n`` physically free blocks, refcount 1 each."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            raise MemoryError(
                f"BlockPool exhausted: {n} blocks requested, "
                f"{len(self._free)} free of {self.n_blocks}")
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._ref[i] = 1
            self._freed.discard(i)
        self._note_peaks()
        return ids

    def share(self, ids) -> None:
        """Increment refcounts: borrow already-resident blocks."""
        ids = [int(i) for i in ids]
        for i in ids:
            if i not in self._ref:
                if self.sanitize and i in self._freed:
                    raise BlockSanitizerError(
                        f"use-after-free: BlockPool.share of block {i}, "
                        "which is not allocated (freed earlier and not "
                        "reallocated)")
                raise ValueError(
                    f"BlockPool.share: block {i} is not allocated; only "
                    "resident blocks can be shared")
        for i in ids:
            self._ref[i] += 1
        self._note_peaks()

    def free(self, ids) -> list:
        """Drop one reference per id; returns the ids physically
        reclaimed by this call (refcount reached zero)."""
        ids = [int(i) for i in ids]
        for i in ids:
            if i not in self._ref:
                if self.sanitize and i in self._freed:
                    raise BlockSanitizerError(
                        f"double free: block {i} is not allocated "
                        "(already freed and not reallocated)")
                raise ValueError(
                    f"BlockPool.free: block {i} is not allocated "
                    "(double free or foreign id)")
        reclaimed = []
        for i in ids:
            self._ref[i] -= 1
            if self._ref[i] == 0:
                del self._ref[i]
                self._free.append(i)
                self._freed.add(i)
                reclaimed.append(i)
        return reclaimed

    release = free

    def allocated_ids(self) -> list:
        return sorted(self._ref)

    def check_write(self, ids) -> None:
        """Sanitizer gate for an imminent arena write into ``ids``:
        raises on an unallocated block or one with refcount > 1."""
        self.n_sanitizer_checks += 1
        for i in (int(i) for i in ids):
            rc = self._ref.get(i)
            if rc is None:
                kind = ("use-after-free" if i in self._freed
                        else "unallocated (wild)")
                raise BlockSanitizerError(
                    f"{kind} write: block {i} is not allocated")
            if rc > 1:
                raise BlockSanitizerError(
                    f"COW violation: write into block {i} with refcount "
                    f"{rc} — shared blocks must be copied "
                    "(copy-on-write) before the first write")

    def check_read(self, ids) -> None:
        """Sanitizer gate for reads: every id must be resident."""
        self.n_sanitizer_checks += 1
        for i in (int(i) for i in ids):
            if i not in self._ref:
                kind = ("use-after-free" if i in self._freed
                        else "unallocated (wild)")
                raise BlockSanitizerError(
                    f"{kind} read: block {i} is not allocated")


def prefix_block_hashes(tokens, block_size: int) -> list:
    """Rolling content hash of each full block of a token sequence.

    ``out[i]`` identifies the (i+1)-block prefix ``tokens[:(i+1)*bs]``:
    each hash chains the previous one, so two sequences share ``out[i]``
    iff they agree on every token up to and including block ``i``.  A
    partial trailing block gets no hash (its content can still grow).
    """
    bs = int(block_size)
    toks = [int(t) for t in tokens]
    out = []
    h = None
    for i in range(len(toks) // bs):
        h = hash((h,) + tuple(toks[i * bs:(i + 1) * bs]))
        out.append(h)
    return out


class PrefixIndex:
    """Content-addressed map: rolling block hash -> resident arena block.

    The scheduler registers every fully written prompt block here and
    holds one pool reference per registered block, so cached prefixes
    stay resident after their owner retires.  Entries are kept in LRU
    order; a block whose only reference is the index's is evictable.
    First writer wins: registering a hash already mapped is a no-op.
    """

    def __init__(self):
        self._by_hash: OrderedDict = OrderedDict()   # hash -> block id
        self._by_block: dict = {}                    # block id -> hash

    def __len__(self) -> int:
        return len(self._by_hash)

    def get(self, h):
        """Resident block id for hash ``h`` (None = miss); bumps LRU."""
        if h in self._by_hash:
            self._by_hash.move_to_end(h)
            return self._by_hash[h]
        return None

    def put(self, h, block_id: int) -> bool:
        """Register ``block_id`` under ``h``; False if already mapped."""
        if h in self._by_hash:
            return False
        block_id = int(block_id)
        if block_id in self._by_block:
            raise ValueError(
                f"PrefixIndex.put: block {block_id} already registered "
                "under another hash")
        self._by_hash[h] = block_id
        self._by_block[block_id] = h
        return True

    def pop_block(self, block_id: int):
        """Drop the entry for ``block_id`` (eviction)."""
        h = self._by_block.pop(int(block_id), None)
        if h is not None:
            del self._by_hash[h]
        return h

    def blocks_lru(self) -> list:
        """Registered block ids, least recently matched first."""
        return list(self._by_hash.values())


def paged_release_rows(cache, rows):
    """Retire paged rows: ``lens -> 0`` and their table rows reset to the
    sentinel.  Arena content is not wiped (freed blocks are overwritten on
    reuse and masked until then); the caller frees the blocks on the
    host."""
    if not is_paged(cache):
        raise ValueError("paged_release_rows: cache is not paged")
    tables = cache["block_tables"]
    rows = torch.as_tensor(rows, device=tables.device).to(torch.bool)
    sentinel = torch.full_like(tables, _paged_sentinel(cache))
    return dict(
        cache,
        block_tables=torch.where(rows[:, None], sentinel, tables),
        lens=torch.where(rows, 0, cache["lens"]).to(torch.int32))


def _paged_sentinel(cache) -> int:
    """The invalid block id (== n_blocks, from any arena leaf's shape)."""
    keys = arena_leaves(cache)
    if not keys:
        raise ValueError("paged cache has no arena content leaves")
    return int(cache[keys[0]].shape[1])


# ---------------------------------------------------------------------------
# Posit-domain cache maintenance (the fused elementwise kernel)
# ---------------------------------------------------------------------------

_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)


def _leaf_is_patterns(key, x) -> bool:
    """Posit-pattern content by the leaf schema: a registered content
    leaf stored unsigned; bookkeeping never; an unknown unsigned leaf
    raises rather than being guessed from its dtype."""
    unsigned = isinstance(x, torch.Tensor) and x.dtype in _UNSIGNED
    if key in CONTENT_LEAVES:
        return unsigned
    if key in META_LEAVES or not unsigned:
        return False
    raise ValueError(
        f"unknown unsigned cache leaf {key!r}: register it in "
        "kvcache.CONTENT_LEAVES (posit patterns) or kvcache.META_LEAVES "
        "(bookkeeping); refusing to guess from the dtype")


def scale_cache(cache, factor: float, name: str):
    """Multiply every posit-pattern leaf by ``factor`` in the posit domain
    (one rounding per element); metadata (lengths, block tables) passes
    through as the same objects.  Returns a new dict."""
    cfg = pcfg_of(name)
    out = {}
    for key, x in cache.items():
        if _leaf_is_patterns(key, x):
            x = kops.vmul(x, scalar_pattern(factor, cfg, x.device), cfg)
        out[key] = x
    return out


def _same_meta(a, b) -> bool:
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and \
            bool(torch.equal(a, b))
    return type(a) is type(b) and a == b


def merge_caches(cache_a, cache_b, name: str, weight_a: float = 0.5):
    """Blend two posit caches, ``wa * a + (1 - wa) * b``: two vmul and a
    vadd per element, each rounded once.  The two caches' metadata
    (lengths, block tables) must agree -- blending K/V of inconsistent
    caches raises."""
    cfg = pcfg_of(name)
    if set(cache_a) != set(cache_b):
        raise ValueError(f"merge_caches: leaves differ: {sorted(cache_a)} vs "
                         f"{sorted(cache_b)}")
    out = {}
    for key, a in cache_a.items():
        b = cache_b[key]
        if _leaf_is_patterns(key, a) and _leaf_is_patterns(key, b):
            wa = scalar_pattern(weight_a, cfg, a.device)
            wb = scalar_pattern(1.0 - float(weight_a), cfg, a.device)
            out[key] = kops.vadd(kops.vmul(a, wa, cfg), kops.vmul(b, wb, cfg),
                                 cfg)
        elif _same_meta(a, b):
            out[key] = a
        else:
            raise ValueError(
                f"merge_caches: non-pattern (metadata) leaf {key!r} differs "
                "between the caches; refusing to blend K/V contents of "
                "inconsistent caches")
    return out
