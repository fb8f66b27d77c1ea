"""positcheck for the port (``repro_torch.analysis``): the reference's
seven rule ids, retargeted to the port's idioms.

Three layers, as in ``tests/test_static_analysis.py``:

* Per-rule fixtures -- each rule fires on a seeded violation in the
  port's idiom, stays silent on the sanctioned idiom and in the
  sanctioned places, and is suppressed by a per-line
  ``# positcheck: disable=PVUxxx`` waiver (listed by ``--show-waived``).
* The regressions in miniature -- ``posit_codec.scatter_slots`` with its
  ``keep`` mask removed writes a -1 slot into the arena's last slot (run
  here) and fires PVU001; ``layers.paged_write_index`` without its
  waiver fires PVU004.
* Repo integration -- ``python -m repro_torch.analysis`` exits 0 on the
  port's tree with ``0 finding(s)``, also with ``torch`` unimportable.

The analyzer is stdlib-only; only the scatter regression imports torch.
"""
import inspect
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import ALL_RULES, rule_by_id, run_paths
from repro_torch.analysis.cli import main as cli_main

REPO = Path(__file__).resolve().parent.parent
RULE_IDS = ["PVU001", "PVU002", "PVU003", "PVU004", "PVU005", "PVU006", "PVU007"]


def _run(tmp_path, code, filename="mod.py"):
    p = tmp_path / filename
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(code))
    active, waived, errors = run_paths([p], ALL_RULES)
    assert not errors, errors
    return active, waived


def _ids(findings):
    return [f.rule_id for f in findings]


# ---------------------------------------------------------------------------
# Per rule: a violation, the sanctioned idiom, a waiver
# ---------------------------------------------------------------------------

# rule id -> (file the violation sits in, the violation, the findings it gives)
BAD = {
    "PVU001": ("runtime/graft.py", """
        def graft(cache, rows, slots, arena):
            cache["k"][slots] = rows
            kv = cache["v"]
            kv.index_copy_(0, slots, rows)
            signed_view(arena).index_put_((slots,), rows)
    """, 3),
    "PVU002": ("runtime/scale.py", """
        def scale(cache, s, cfg):
            return quantize(dequantize_many([cache], cfg)[0] * s, cfg)
    """, 1),
    "PVU003": ("runtime/sniff.py", """
        import torch

        def is_patterns(cache):
            return cache["k"].dtype == torch.uint16

        def is_float(kv_cache):
            return kv_cache["v"].is_floating_point()
    """, 2),
    "PVU004": ("models/step.py", """
        import torch

        def decode_step(x, lens):
            n = int(lens.max().item())
            rows = torch.nonzero(lens > 0)[:, 0]
            idx = (lens > 0).nonzero()
            return x[rows].cpu().numpy(), idx.tolist(), n
    """, 6),
    "PVU005": ("runtime/steal.py", """
        def steal(pool, bid):
            pool._free.append(bid)
            del pool._ref[bid]
    """, 2),
    "PVU006": ("runtime/dispatch.py", """
        import functools
        import torch

        class Runner:
            def prefill(self, toks, prompt_len):
                self._dispatch_keys.add(("prefill", prompt_len))

        @functools.lru_cache(maxsize=None)
        def plan(plen):
            return plen

        def step(x, seq_len):
            return x[:seq_len]

        fast = torch.compile(step, dynamic=False)
    """, 3),
    "PVU007": ("models/pool.py", """
        import torch

        def grow_pool(cfg, nb, bs):
            arena = torch.zeros((cfg.n_layers, nb, bs, 4, 8), dtype=torch.uint16)
            return arena

        class Engine:
            def adopt(self, cache):
                if self.mesh is not None:
                    return {k: cache[k].to(self.device) for k in cache}
                return cache.cuda()
    """, 3),
}

# rule id -> [(file, the sanctioned idiom or place)]
GOOD = {
    "PVU001": [
        ("runtime/graft.py", """
            def graft(cache, rows, slots, cfg):
                T._write_kv([(cache["k"][0], rows)], slots, cfg)
                for li in range(cfg.n_layers):
                    cache["ssm"][li] = rows
                for li, lp in enumerate(cfg.layers):
                    cache["wkv"][li] = lp
                cache["k"][:, :4] = rows
                cache["lens"] = cache["lens"] + 1
                lens = cache["lens"].clone()
                lens[slots] = 0
                return lens
        """),
        ("kernels/posit_codec.py", """
            def scatter_slots(jobs, slots, dense=False):
                for arena, rows in jobs:
                    flat = signed_view(arena).view(-1, 4)
                    flat[slots] = rows
        """),
        ("models/layers.py", """
            def paged_write(arena, upd, index):
                rows, blocks, offs = index
                signed_view(arena)[blocks, offs] = signed_view(upd)[rows]

            def reset_cache_rows(kv, rows):
                signed_view(kv).index_fill_(1, rows, 0)
        """),
    ],
    "PVU002": [
        ("runtime/scale.py", """
            def scale(cache, s, ops, cfg):
                return ops.vmul(cache, s, cfg)

            def encode(x, cfg):
                return posit_to_f32(f32_to_posit(x, cfg), cfg)
        """),
        ("kernels/posit_ew.py", BAD["PVU002"][1]),
        ("compress/kvcache.py", BAD["PVU002"][1]),
    ],
    "PVU003": [
        ("runtime/sniff.py", """
            import torch

            def classify(key, CONTENT_LEAVES):
                return key in CONTENT_LEAVES

            def weights(w):
                return w.dtype == torch.uint16 or w.is_floating_point()

            def poison(arena):
                return arena.dtype in (torch.uint8, torch.uint16)
        """),
        ("compress/kvcache.py", BAD["PVU003"][1]),
    ],
    "PVU004": [
        ("models/step.py", """
            import numpy as np

            def plan(mask):
                return np.nonzero(mask)[0]

            def cast(x):
                return x.to("cpu", non_blocking=True).cpu
        """),
        ("runtime/scheduler.py", BAD["PVU004"][1]),
        ("launch/serve.py", BAD["PVU004"][1]),
    ],
    "PVU005": [
        ("runtime/borrow.py", """
            def borrow(pool, ids):
                pool.share(ids)
                return pool.refcount(ids[0]), pool.n_free

            def retire(pool, ids):
                return pool.release(ids)
        """),
        ("compress/kvcache.py", """
            class BlockPool:
                def alloc(self, n):
                    return [self._free.pop() for _ in range(n)]
        """),
    ],
    "PVU006": [
        ("runtime/dispatch.py", """
            import functools

            class Runner:
                def mixed(self, c, n_steps, max_len):
                    self._dispatch_keys.add(("mixed", int(c), int(n_steps), max_len))

            @functools.lru_cache(maxsize=None)
            def split_chunk(block_size, max_len, window):
                return block_size

            def plain(seq_len):
                return seq_len
        """),
        ("runtime/engine.py", BAD["PVU006"][1]),
    ],
    "PVU007": [
        ("runtime/engine2.py", """
            import torch

            def init_paged_cache(cfg, nb, bs, device=None):
                arena = torch.zeros((cfg.n_layers, nb, bs, 4, 8), device=device)
                return {"k": arena}

            def rank_cache(cfg, mesh, nb, bs):
                arena = torch.empty((cfg.n_layers, nb, bs), dtype=torch.uint16)
                return arena

            def gather(cache, shards):
                cache_full = torch.zeros_like(cache["k"])
                return cache_full

            def cast(cache, cfg):
                return cache["k"].to(torch.float32)
        """),
        ("kernels/scratch.py", BAD["PVU007"][1]),
    ],
}

# rule id -> (file, a violation carrying its waiver on the flagged line or
# on the statement's first line)
WAIVED = {
    "PVU001": ("runtime/graft.py", """
        def graft(cache, row, v):
            # row is a free slot of the scheduler: in range
            cache["lens"][row] = v  # positcheck: disable=PVU001
    """),
    "PVU002": ("runtime/scale.py", """
        def slow_reference(cache, s, cfg):
            return quantize(dequantize(cache, cfg) * s, cfg)  # positcheck: disable=PVU002
    """),
    "PVU003": ("runtime/sniff.py", """
        import torch

        def probe(cache):
            return cache["k"].dtype == torch.uint16  # positcheck: disable=PVU003
    """),
    "PVU004": ("kernels/scatter.py", """
        import torch

        def scatter(slots, n):
            # one sync a call, off the decode step
            keep = torch.nonzero(  # positcheck: disable=PVU004
                (slots >= 0) & (slots < n))[:, 0]
            return keep
    """),
    "PVU005": ("runtime/debug.py", """
        def debug_dump(pool):
            return list(pool._ref)  # positcheck: disable=PVU005
    """),
    "PVU006": ("runtime/dispatch.py", """
        import functools

        @functools.lru_cache(maxsize=None)  # positcheck: disable=PVU006
        def plan(plen):
            return plen
    """),
    "PVU007": ("runtime/debug.py", """
        import torch

        def snapshot(cfg, nb):
            # a host-side debugging copy; never served from
            cache = torch.zeros((nb, 4))  # positcheck: disable=PVU007
            return cache
    """),
}


@pytest.mark.parametrize("rid", RULE_IDS)
def test_rule_fires_on_seeded_violation(tmp_path, rid):
    filename, code, n = BAD[rid]
    active, _ = _run(tmp_path, code, filename)
    assert _ids(active) == [rid] * n, [f.format() for f in active]
    assert all(f.hint == rule_by_id(rid).hint for f in active)


@pytest.mark.parametrize("rid", RULE_IDS)
def test_rule_silent_on_sanctioned_idiom_and_places(tmp_path, rid):
    for i, (filename, code) in enumerate(GOOD[rid]):
        active, _ = _run(tmp_path / str(i), code, filename)
        assert active == [], (filename, [f.format() for f in active])


@pytest.mark.parametrize("rid", RULE_IDS)
def test_rule_waiver_suppresses_with_audit_trail(tmp_path, rid, capsys):
    filename, code = WAIVED[rid]
    active, waived = _run(tmp_path, code, filename)
    assert active == [] and _ids(waived) == [rid]
    assert cli_main([str(tmp_path / filename), "--show-waived"]) == 0
    out = capsys.readouterr().out
    assert f"[waived] {tmp_path / filename}" in out and rid in out
    assert "0 finding(s) (0 error, 0 warning, 1 waived)" in out


def test_pvu002_is_a_warning_pointing_at_the_fused_kernels(tmp_path):
    active, _ = _run(tmp_path, BAD["PVU002"][1], BAD["PVU002"][0])
    assert active[0].severity == "warning" and "vadd" in active[0].hint


def test_pvu001_sanctions_each_writer_only_in_its_own_file(tmp_path):
    """The same write is silent in its sanctioned function and file, and
    fires in a same-named function elsewhere."""
    code = """
        def {fn}(arena, rows, slots):
            signed_view(arena)[slots] = rows
    """
    for path, fn in sorted(rule_by_id("PVU001").ALLOWED):
        active, _ = _run(tmp_path / "in", code.format(fn=fn), path)
        assert active == [], (path, fn)
        active, _ = _run(tmp_path / "out", code.format(fn=fn), "runtime/elsewhere.py")
        assert _ids(active) == ["PVU001"], fn


# ---------------------------------------------------------------------------
# The regressions in miniature
# ---------------------------------------------------------------------------

def _scatter_without_mask() -> str:
    """``posit_codec.scatter_slots``'s own source with its ``keep`` mask
    removed: every slot written, -1 included."""
    from repro_torch.kernels import posit_codec

    src = inspect.getsource(posit_codec.scatter_slots)
    for old, new in (
            ("    keep = None if dense else torch.nonzero(  # positcheck: disable=PVU004\n"
             "        (slots >= 0) & (slots < n_slots))[:, 0]\n", ""),
            ("dst = slots if dense else slots[keep]", "dst = slots"),
            ("flat[dst] = src if dense else src[keep]", "flat[dst] = src")):
        assert old in src, old
        src = src.replace(old, new)
    return "import torch\nfrom repro_torch.core.types import signed_view\n\n\n" + src


def test_pvu001_fires_on_scatter_slots_without_its_mask(tmp_path):
    import torch

    from repro_torch.kernels import posit_codec

    code = _scatter_without_mask()
    active, _ = _run(tmp_path, code, "kernels/scatter_copy.py")
    assert _ids(active) == ["PVU001"]
    assert "wraps to the last slot" in active[0].message
    # the bug it encodes: a -1 slot overwrites the arena's last slot; the
    # masked writer drops it
    ns = {}
    exec(compile(code, "scatter_copy", "exec"), ns)
    arena = torch.zeros((2, 4, 3), dtype=torch.uint16)
    rows = torch.full((2, 3), 7, dtype=torch.uint16)
    slots = torch.tensor([1, -1])
    ns["scatter_slots"]([(arena, rows)], slots)
    assert arena[1, 3].tolist() == [7, 7, 7]           # the last slot, clobbered
    arena.zero_()
    posit_codec.scatter_slots([(arena, rows)], slots)
    assert arena[1, 3].tolist() == [0, 0, 0] and arena[0, 1].tolist() == [7, 7, 7]


def test_pvu004_fires_on_paged_write_index_without_its_waiver(tmp_path):
    from repro_torch.models import layers

    src = inspect.getsource(layers.paged_write_index)
    assert "# positcheck: disable=PVU004" in src
    active, waived = _run(tmp_path, src, "models/layers_copy.py")
    assert active == [] and _ids(waived) == ["PVU004"]
    bare = src.replace("  # positcheck: disable=PVU004", "")
    active, waived = _run(tmp_path, bare, "models/layers_copy.py")
    assert _ids(active) == ["PVU004"] and waived == []


# ---------------------------------------------------------------------------
# Framework behaviour
# ---------------------------------------------------------------------------

def test_disable_all_waives_every_rule_on_the_line(tmp_path):
    active, waived = _run(tmp_path, """
        import torch

        def graft(cache, rows, slots):
            cache["k"][torch.nonzero(slots)] = rows  # positcheck: disable=all
    """, "models/graft.py")
    assert active == [] and sorted(_ids(waived)) == ["PVU001", "PVU004"]


def test_waiver_on_other_line_does_not_suppress(tmp_path):
    active, _ = _run(tmp_path, """
        # positcheck: disable=PVU001

        def graft(cache, rows, slots):
            cache["k"][slots] = rows
    """)
    assert _ids(active) == ["PVU001"]


def test_rule_registry_is_complete():
    assert [r.id for r in ALL_RULES] == RULE_IDS
    for rid in RULE_IDS:
        r = rule_by_id(rid)
        assert r.severity in ("error", "warning")
        assert r.hint and r.title
    with pytest.raises(KeyError):
        rule_by_id("PVU008")


def test_syntax_error_is_reported_not_fatal(tmp_path):
    (tmp_path / "broken.py").write_text("def f(:\n")
    (tmp_path / "fine.py").write_text("x = 1\n")
    active, waived, errors = run_paths([tmp_path], ALL_RULES)
    assert active == [] and waived == []
    assert len(errors) == 1 and "broken.py" in errors[0]


# ---------------------------------------------------------------------------
# Repo integration: the lint contract
# ---------------------------------------------------------------------------

def _analysis(*args, code=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    cmd = [sys.executable, "-m", "repro_torch.analysis", *args] if code is None \
        else [sys.executable, "-c", code, *args]
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True)


def test_port_tree_is_positcheck_clean():
    proc = _analysis()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout
    # the five known host syncs, the scheduler's lens write and the
    # quickstart's round trip stay waived
    proc = _analysis("--show-waived")
    assert proc.stdout.count("[waived]") == 8
    assert proc.stdout.count("PVU004") == 6 and proc.stdout.count("PVU001") == 1
    assert proc.stdout.count("PVU002") == 1


def test_cli_exits_nonzero_on_findings(tmp_path):
    bad = tmp_path / "kernels" / "scatter_copy.py"
    bad.parent.mkdir()
    bad.write_text(_scatter_without_mask())
    proc = _analysis(str(bad))
    assert proc.returncode == 1
    assert "PVU001" in proc.stdout and "1 finding(s)" in proc.stdout


def test_cli_list_rules():
    proc = _analysis("--list-rules")
    assert proc.returncode == 0
    for rid in RULE_IDS:
        assert rid in proc.stdout


def test_positcheck_needs_no_torch():
    """With ``torch`` unimportable the analyzer still runs on the tree:
    it is stdlib-only."""
    proc = _analysis(code=(
        "import sys\n"
        "sys.modules['torch'] = None\n"
        "from repro_torch.analysis.cli import main\n"
        "code = main(['src/repro_torch'])\n"
        "assert 'torch' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "sys.exit(code)\n"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout
