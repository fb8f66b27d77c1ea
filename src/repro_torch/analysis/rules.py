"""The positcheck rules (PVU001-PVU007), retargeted to the port's idioms.

The ids and the bug classes are the reference's (``repro/analysis``);
the spellings they match are PyTorch's: an index write where the
reference wrote ``lax.dynamic_update_slice``, a host sync where it
branched on a traced value, a dispatch key where it had a jit static
argument, a fresh ``torch.zeros`` where it had a ``device_put``.

Rules are syntactic and deliberately conservative: they match the
idioms used in this package, not every conceivable spelling.  A miss
is acceptable; a false positive on idiomatic code is not -- anything
that must stay gets a per-line ``# positcheck: disable=PVUxxx`` waiver
with a comment explaining why the invariant holds there.
"""
from __future__ import annotations

import ast

from .core import ModuleFile, Rule

# ---------------------------------------------------------------------------
# shared walkers


def _leaf(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _statements_with_fn(tree: ast.Module):
    """Yield every node with its innermost enclosing function def (None
    at module level)."""

    def walk(node: ast.AST, fn):
        for child in ast.iter_child_nodes(node):
            yield child, fn
            yield from walk(child, child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn)

    yield from walk(tree, None)


def _mentions(node: ast.AST, words: tuple[str, ...]) -> bool:
    """Does any name or attribute in this expression contain one of
    ``words``?"""
    for sub in ast.walk(node):
        ident = (sub.id if isinstance(sub, ast.Name)
                 else sub.attr if isinstance(sub, ast.Attribute) else "")
        if any(w in ident.lower() for w in words):
            return True
    return False


def _contains_cacheish_name(node: ast.AST) -> bool:
    """Does this expression mention a cache-derived variable?"""
    return _mentions(node, ("cache",))


def _in_dirs(mod: ModuleFile, *dirs: str) -> bool:
    parts = mod.path.parts
    return any(d in parts for d in dirs)


def _is_file(mod: ModuleFile, suffix: str) -> bool:
    return mod.path.as_posix().endswith(suffix)


def _param_names(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> list[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


# ---------------------------------------------------------------------------
# PVU001 -- index writes into a cache outside the masking writers


class RawCacheWrite(Rule):
    id = "PVU001"
    severity = "error"
    title = "index write into a cache, arena or KV tensor outside the masking writers"
    hint = (
        "route the write through transformer._write_kv / "
        "posit_codec.scatter_slots / posit_codec.paged_write (paged and "
        "linear slots; -1 and out-of-range slots DROP) or the block "
        "helpers of models/layers.py -- a PyTorch index of -1 WRAPS to "
        "the last slot and silently overwrites it (the reference's "
        "clamp-overwrite bug in PyTorch's spelling). If the index is "
        "provably in range, waive with '# positcheck: disable=PVU001' plus "
        "a comment proving the bound."
    )

    WORDS = ("cache", "arena", "kv")
    INDEX_WRITES = {"index_copy_", "index_fill_", "index_put_"}
    # calls whose result is a view of their receiver (or of their first
    # argument, for the free function ``signed_view``): a write through
    # it is a write into the cache
    VIEWS = {"view", "reshape", "signed_view", "flatten", "unflatten",
             "select", "narrow", "expand", "permute", "transpose",
             "unsqueeze", "squeeze", "view_as", "movedim"}
    # the sanctioned writers, by file and function, each of which drops
    # the slots it must not write:
    ALLOWED = {
        # posit KV through the fused write, whose kernel skips -1 and
        # out-of-range slots on the device; other KV through scatter_slots
        ("models/transformer.py", "_write_kv"),
        # keeps only slots in [0, nb * bs) (``keep``), or, with ``dense``,
        # slots its caller has checked against the capacity
        ("kernels/posit_codec.py", "scatter_slots"),
        # the fused write's operator: its kernel and plain version drop
        # what scatter_slots drops
        ("kernels/posit_codec.py", "paged_write"),
        # rows named by a mask, through nonzero: never a sentinel
        ("models/layers.py", "reset_cache_rows"),
        # indices from paged_write_index, which keeps rows with slot >= 0
        ("models/layers.py", "paged_write"),
        # keeps table entries in [0, nb)
        ("models/layers.py", "paged_pack"),
        # keeps slots >= 0 of paged_pack_slots, which are in range
        ("models/layers.py", "paged_pack_range"),
        # drops destinations outside [0, nb), clamps sources
        ("models/layers.py", "paged_copy_blocks"),
        # drops ids outside [0, nb)
        ("models/layers.py", "paged_poison_blocks"),
    }

    def _root_idents(self, node: ast.AST) -> list[str]:
        """Identifiers along the receiver chain of ``node``: through
        subscripts, attributes and view calls to the tensor written."""
        out: list[str] = []
        while True:
            if isinstance(node, ast.Name):
                out.append(node.id)
                return out
            if isinstance(node, ast.Attribute):
                out.append(node.attr)
                node = node.value
            elif isinstance(node, ast.Subscript):
                node = node.value
            elif isinstance(node, ast.Call):
                name = (node.func.attr if isinstance(node.func, ast.Attribute)
                        else _leaf(self.call_name(node)))
                if name not in self.VIEWS:
                    return out
                if isinstance(node.func, ast.Attribute) and name != "signed_view":
                    node = node.func.value
                elif node.args:
                    node = node.args[0]
                else:
                    return out
            else:
                return out

    def _cacheish(self, node: ast.AST, aliases: set[str]) -> bool:
        idents = self._root_idents(node)
        return any(i in aliases or any(w in i.lower() for w in self.WORDS)
                   for i in idents)

    @staticmethod
    def _range_targets(fn) -> set[str]:
        """Names bound by ``for i in range(...)`` or as the counter of
        ``for i, x in enumerate(...)`` in ``fn``: in range by construction."""
        names: set[str] = set()
        for node in ast.walk(fn):
            if not (isinstance(node, ast.For) and isinstance(node.iter, ast.Call)):
                continue
            it = _leaf(Rule.call_name(node.iter))
            if it == "range" and isinstance(node.target, ast.Name):
                names.add(node.target.id)
            elif (it == "enumerate" and isinstance(node.target, ast.Tuple)
                  and node.target.elts and isinstance(node.target.elts[0], ast.Name)):
                names.add(node.target.elts[0].id)
        return names

    @staticmethod
    def _basic_index(index: ast.AST, safe: set[str]) -> bool:
        """Slices, ``...``, ``None``, non-negative int literals and loop
        counters: no sentinel can wrap through them."""
        parts = index.elts if isinstance(index, ast.Tuple) else [index]
        for p in parts:
            if isinstance(p, ast.Slice):
                continue
            if isinstance(p, ast.Constant) and (
                    p.value is None or p.value is Ellipsis
                    or (isinstance(p.value, int) and p.value >= 0)):
                continue
            if isinstance(p, ast.Name) and p.id in safe:
                continue
            return False
        return True

    def _allowed(self, mod: ModuleFile, fn) -> bool:
        return fn is not None and any(
            fn.name == f and _is_file(mod, path) for path, f in self.ALLOWED)

    def _check_fn(self, mod: ModuleFile, fn, body):
        aliases: set[str] = set()
        safe = self._range_targets(fn) if fn is not None else set()
        for node in body:
            if isinstance(node, ast.Assign):
                if self._cacheish(node.value, aliases):
                    aliases.update(t.id for t in node.targets if isinstance(t, ast.Name))
                targets = node.targets
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
            elif isinstance(node, ast.Call):
                name = node.func.attr if isinstance(node.func, ast.Attribute) else ""
                if name in self.INDEX_WRITES and self._cacheish(node.func.value, aliases):
                    yield node, (f"{name} into a cache/arena tensor (a -1 index "
                                 "wraps to the last slot) outside the masking "
                                 "writers")
                continue
            else:
                continue
            for t in targets:
                if (isinstance(t, ast.Subscript)
                        and not (isinstance(t.slice, ast.Constant)
                                 and isinstance(t.slice.value, str))
                        and not self._basic_index(t.slice, safe)
                        and self._cacheish(t.value, aliases)):
                    yield node, ("index write into a cache/arena tensor (a -1 "
                                 "index wraps to the last slot) outside the "
                                 "masking writers")

    def check(self, mod: ModuleFile):
        # each function's own statements (nested defs get their own pass),
        # in source order so that aliases precede their uses
        scopes: dict = {None: []}
        for node, fn in _statements_with_fn(mod.tree):
            scopes.setdefault(fn, []).append(node)
        for fn, body in scopes.items():
            if not self._allowed(mod, fn):
                yield from self._check_fn(mod, fn, body)


# ---------------------------------------------------------------------------
# PVU002 -- dequant -> f32 -> requant round-trips outside kernels/ and compress/


class RequantRoundTrip(Rule):
    id = "PVU002"
    severity = "warning"
    title = "dequantize->f32->requantize round-trip outside approved internals"
    hint = (
        "the fused posit-domain kernels (kernels.ops.vadd/vsub/vmul/vdiv, "
        "pgemm; csrc/posit_ew.cu, posit_qgemm.cu) exist to replace "
        "decode->f32-op->re-encode round-trips; compute in the posit domain "
        "or move the round-trip into kernels/ or compress/ internals"
    )

    QUANT = {"f32_to_posit", "quantize", "quantize_call", "quantize_cache"}
    DEQUANT = {"posit_to_f32", "dequantize", "dequantize_many", "dequantize_call",
               "dequantize_cache"}
    ALLOWED_DIRS = ("kernels", "compress")

    def check(self, mod: ModuleFile):
        if _in_dirs(mod, *self.ALLOWED_DIRS):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if _leaf(self.call_name(node)) not in self.QUANT:
                continue
            args = list(node.args) + [kw.value for kw in node.keywords]
            if any(isinstance(sub, ast.Call)
                   and _leaf(self.call_name(sub)) in self.DEQUANT
                   for arg in args for sub in ast.walk(arg)):
                yield node, ("requantizing a freshly dequantized value "
                             "(dequant->f32->requant round-trip)")


# ---------------------------------------------------------------------------
# PVU003 -- dtype sniffing on cache leaves instead of the leaf schema


class CacheDtypeSniff(Rule):
    id = "PVU003"
    severity = "error"
    title = "dtype sniffing on cache leaves instead of the leaf schema"
    hint = (
        "classify cache leaves by NAME via kvcache.CONTENT_LEAVES / "
        "META_LEAVES -- dtype sniffing breaks when integer metadata leaves "
        "(lens, block_tables) sit beside the pattern leaves in the cache"
    )

    # the schema implementation itself may inspect dtypes
    ALLOWED_FILE = "compress/kvcache.py"

    def check(self, mod: ModuleFile):
        if _is_file(mod, self.ALLOWED_FILE):
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "is_floating_point"
                        and _contains_cacheish_name(node.func.value)):
                    yield node, ("is_floating_point() on a cache-derived leaf -- "
                                 "dtype sniffing instead of the "
                                 "CONTENT_LEAVES/META_LEAVES schema")
            elif isinstance(node, ast.Compare):
                if not all(isinstance(op, (ast.Eq, ast.NotEq)) for op in node.ops):
                    continue
                for side in [node.left] + node.comparators:
                    if (isinstance(side, ast.Attribute) and side.attr == "dtype"
                            and _contains_cacheish_name(side)):
                        yield node, ("comparing .dtype of a cache-derived leaf -- "
                                     "dtype sniffing instead of the "
                                     "CONTENT_LEAVES/META_LEAVES schema")
                        break


# ---------------------------------------------------------------------------
# PVU004 -- host syncs in step code


class HostSync(Rule):
    id = "PVU004"
    severity = "error"
    title = "host sync in step code (models/, kernels/)"
    hint = (
        "a host sync (nonzero, .item(), .tolist(), .cpu(), .numpy()) stalls "
        "the stream every step and cannot be captured in a CUDA graph of "
        "the decode step; keep the value on the device (a mask, "
        "torch.where, a -1 slot the writer drops) or compute it on the host "
        "from host data. Where the sync must stay, waive with "
        "'# positcheck: disable=PVU004' plus a comment saying how often "
        "it syncs and why"
    )

    SCOPED_DIRS = ("models", "kernels")
    SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
    # numpy's nonzero runs on host arrays: no device in sight
    HOST_MODULES = {"np", "numpy"}

    def check(self, mod: ModuleFile):
        if not _in_dirs(mod, *self.SCOPED_DIRS):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = self.call_name(node)
            if isinstance(node.func, ast.Attribute) and node.func.attr == "nonzero":
                owner = self.dotted_name(node.func.value)
                if owner in self.HOST_MODULES:
                    continue
                yield node, ("nonzero() synchronizes with the host (its "
                             "output shape depends on the data)")
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in self.SYNC_METHODS and not node.args
                  and not node.keywords):
                yield node, (f".{node.func.attr}() copies to the host and "
                             "synchronizes the stream")
            elif name == "nonzero":
                yield node, ("nonzero() synchronizes with the host (its "
                             "output shape depends on the data)")


# ---------------------------------------------------------------------------
# PVU005 -- reaching into BlockPool private state


class PoolPrivateAccess(Rule):
    id = "PVU005"
    severity = "error"
    title = "BlockPool private state accessed outside the allocator"
    hint = (
        "go through the refcount API -- alloc()/share()/release() (free is "
        "the decref alias) -- never the private free list or refcount "
        "table; direct mutation desynchronizes refcounts from the "
        "PrefixIndex and corrupts copy-on-write (shared blocks get "
        "reused while still referenced)"
    )

    PRIVATE_ATTRS = {"_free", "_ref", "_freed"}
    ALLOWED_FILE = "compress/kvcache.py"

    def check(self, mod: ModuleFile):
        if _is_file(mod, self.ALLOWED_FILE):
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute) and node.attr in self.PRIVATE_ATTRS:
                yield node, (
                    f"direct access to BlockPool private state '.{node.attr}' "
                    "bypasses the refcount API (share/release)"
                )


# ---------------------------------------------------------------------------
# PVU006 -- dispatch keyed on prompt-length-like values


class PromptLenSpecialization(Rule):
    id = "PVU006"
    severity = "error"
    title = "a dispatch key or cached function keyed on a prompt-length-like value"
    hint = (
        "a dispatch key (the engine's _dispatch_keys, the port's count of "
        "compiled programs), an lru_cache or a torch.compile(dynamic=False) "
        "keyed on a prompt/prefix/sequence length makes one program PER "
        "LENGTH -- the recompile-per-prompt stall chunked prefill "
        "(Engine.mixed_step, one shape for every request) deleted; pass "
        "lengths as tensors (per-row lens/n_valid) or route the dispatch "
        "through runtime/engine.py, the one place allowed to manage it"
    )

    ALLOWED_FILE = "runtime/engine.py"
    CACHES = {"lru_cache", "cache"}
    # length-like: 'plen' itself, or a *_len name scoped to prompt-ish
    # data.  Capacity names (max_len, block/window sizes) stay legal.
    SCOPES = ("prompt", "prefix", "seq", "suffix", "token")

    def _length_like(self, name) -> bool:
        n = str(name).lower()
        if n in ("plen", "seqlen"):
            return True
        return "len" in n and any(s in n for s in self.SCOPES)

    def _static_compile(self, node: ast.AST) -> bool:
        """``torch.compile(..., dynamic=False)``, called or as a decorator."""
        return (isinstance(node, ast.Call) and _leaf(self.call_name(node)) == "compile"
                and any(kw.arg == "dynamic" and isinstance(kw.value, ast.Constant)
                        and kw.value.value is False for kw in node.keywords))

    def _keyed(self, dec: ast.AST) -> bool:
        target = dec.func if isinstance(dec, ast.Call) else dec
        return _leaf(self.dotted_name(target)) in self.CACHES or self._static_compile(dec)

    def check(self, mod: ModuleFile):
        if _is_file(mod, self.ALLOWED_FILE):
            return
        fndefs = {f.name: f for f in ast.walk(mod.tree)
                  if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))}
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                keyed = [d for d in node.decorator_list if self._keyed(d)]
                if not keyed:
                    continue
                for p in _param_names(node):
                    if self._length_like(p):
                        # anchored on the decorator: its line takes the waiver
                        yield keyed[0], (f"cached or statically compiled '{node.name}' "
                                     f"is keyed on prompt-length-like {p!r} -- one "
                                     "program per prompt length, outside the "
                                     "engine's dispatch")
            elif isinstance(node, ast.Call):
                name = self.call_name(node)
                if _leaf(name) == "add" and "_dispatch_keys" in name:
                    for sub in ast.walk(node):
                        ident = (sub.id if isinstance(sub, ast.Name)
                                 else sub.attr if isinstance(sub, ast.Attribute) else "")
                        if ident and self._length_like(ident):
                            yield node, ("dispatch key includes prompt-length-like "
                                         f"{ident!r} -- one program per prompt "
                                         "length, outside the engine's dispatch")
                            break
                elif self._static_compile(node):
                    for a in node.args[:1]:
                        fn = fndefs.get(_leaf(self.dotted_name(a)))
                        for p in _param_names(fn) if fn is not None else ():
                            if self._length_like(p):
                                yield node, (f"torch.compile(dynamic=False) of "
                                             f"'{fn.name}' specializes on prompt-"
                                             f"length-like {p!r} -- one program "
                                             "per prompt length")


# ---------------------------------------------------------------------------
# PVU007 -- cache/arena created or moved whole where a rank holds a share


class UnshardedCachePlacement(Rule):
    id = "PVU007"
    severity = "error"
    title = "cache/arena created or moved whole outside the rank-aware constructors"
    hint = (
        "under a mesh each rank allocates only its own share of a cache "
        "(the rank-local config's heads: Engine.init_cache, the families' "
        "init_cache / init_paged_cache); a fresh torch.zeros/empty/full "
        "arena elsewhere in runtime/ or models/, or a cache tree moved "
        "with .to(device)/.cuda() beside a mesh, holds the WHOLE cache on "
        "every rank, forfeiting the per-device footprint.  Sanctioned: "
        "init* functions and functions whose signature carries the mesh "
        "or the shards; anything else that must stay gets "
        "'# positcheck: disable=PVU007' plus a comment naming where the "
        "share is taken."
    )

    SCOPED_DIRS = ("runtime", "models")
    CREATORS = {"zeros", "full", "empty", "zeros_like", "full_like", "empty_like",
                "new_zeros", "new_full", "new_empty"}
    SHARDY = ("mesh", "shards")

    @staticmethod
    def _cache_or_arena(node: ast.AST) -> bool:
        return _mentions(node, ("cache", "arena"))

    def _sanctioned(self, fn) -> bool:
        return fn is not None and (fn.name.startswith("init") or any(
            s in p.lower() for p in _param_names(fn) for s in self.SHARDY))

    @staticmethod
    def _under_mesh(fn) -> bool:
        return fn is not None and _mentions(fn, ("mesh",))

    @staticmethod
    def _device_move(call: ast.Call) -> bool:
        if not isinstance(call.func, ast.Attribute):
            return False
        if call.func.attr == "cuda":
            return True
        if call.func.attr != "to":
            return False
        if any(kw.arg == "device" for kw in call.keywords):
            return True
        return any(_mentions(a, ("dev",)) or (isinstance(a, ast.Constant)
                                              and str(a.value).startswith(("cuda", "cpu")))
                   for a in call.args)

    def check(self, mod: ModuleFile):
        if not _in_dirs(mod, *self.SCOPED_DIRS):
            return
        for node, fn in _statements_with_fn(mod.tree):
            if self._sanctioned(fn):
                continue
            if isinstance(node, ast.Call):
                if (self._device_move(node) and self._under_mesh(fn)
                        and self._cache_or_arena(node.func.value)):
                    yield node, ("a cache tree moved whole to a device beside a "
                                 "mesh -- every rank holds all of it")
                continue
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            value = node.value
            if not (isinstance(value, ast.Call)
                    and _leaf(self.call_name(value)) in self.CREATORS):
                continue
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if any(self._cache_or_arena(t) for t in targets):
                yield node, ("fresh cache/arena materialized outside an init* "
                             "constructor or a function given the mesh or the "
                             "shards -- every rank holds the whole of it")


ALL_RULES: tuple[Rule, ...] = (
    RawCacheWrite(),
    RequantRoundTrip(),
    CacheDtypeSniff(),
    HostSync(),
    PoolPrivateAccess(),
    PromptLenSpecialization(),
    UnshardedCachePlacement(),
)


def rule_by_id(rule_id: str) -> Rule:
    for r in ALL_RULES:
        if r.id == rule_id:
            return r
    raise KeyError(rule_id)
