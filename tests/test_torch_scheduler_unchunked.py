"""The port's dense-cache and unchunked paged schedulers against the
reference scheduler.

Mirrors the unchunked parts of ``tests/test_scheduler.py`` and
``tests/test_paged.py`` at reduced width, with the reference's
parameters carried over by ``weights.params_from_jax``.  On the dense,
sliding-window and MLA lanes, at f32, posit16 and posit8 KV, the same
submissions through a two-slot pool (midstream admissions, recycled
slots) give per-request greedy tokens, admission and finish steps, and
scheduler counters (``n_compiles`` included: one prefill per prompt
length plus the decode quantum) equal to the reference dense-cache
scheduler's, from both of the port's schedulers; the paged one runs the
arena sanitizer and ends with every block free.  A tight ``max_len``
forces compaction; a tight pool defers admissions.

The EOS cases do not copy ``tests/test_scheduler.py::
test_eos_stops_early_and_frees_the_slot``: that test takes the third
greedy token as ``eos_id``, but the greedy stream it uses opens
``[205, 205, 205, ...]``, so the scheduler rightly stops at the first
token.  Here the ``eos_id`` is a token that first appears at index 2 of
the reference's greedy stream.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro import configs as RCFG
from repro.models import get_family
from repro.runtime.engine import Engine as RefEngine
from repro.runtime.scheduler import Scheduler as RefScheduler
from repro_torch import configs as TCFG
from repro_torch.compress import kvcache as kvc
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import Scheduler
from repro_torch.weights import params_from_jax

LANES = ["dense", "window", "mla"]
KVS = [None, "posit16", "posit8"]
KV_IDS = ["f32", "posit16", "posit8"]
COUNTERS = ("n_admitted", "n_retired", "n_chunks", "steps_run", "n_preempted",
            "prefill_tokens", "n_compiles")


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfgs(lane, kv=None):
    arch = "minicpm3-4b" if lane == "mla" else "phi3-medium-14b"
    rc = RCFG.get_config(arch).reduced(compute_dtype="float32", kv_posit=kv)
    tc = TCFG.get_config(arch).reduced(compute_dtype="float32", kv_posit=kv)
    if lane == "window":
        rc = dataclasses.replace(rc, sliding_window=8, attn_chunk_kv=8)
        tc = dataclasses.replace(tc, sliding_window=8, attn_chunk_kv=8)
    return rc, tc


_PARAMS = {}


def _params(lane):
    if lane not in _PARAMS:
        rc, tc = _cfgs(lane)
        rp = get_family(rc).init_params(jax.random.PRNGKey(0), rc)
        _PARAMS[lane] = (rp, params_from_jax(jax.tree.map(np.asarray, rp), tc,
                                             device="cpu"))
    return _PARAMS[lane]


def _run(sched, prompts, gens, **kw):
    rids = [sched.submit(p, g, **kw) for p, g in zip(prompts, gens)]
    done = sched.run(max_rounds=200)
    return [done[r] for r in rids]


def _same_completions(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert (g.admitted_step, g.finished_step) == \
            (w.admitted_step, w.finished_step)


def _workload(cfg):
    """Five requests, three prompt lengths (the window lane's 9-token
    prompts overrun its 8-slot ring), through a two-slot pool."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in (5, 9, 3, 9, 5)]
    return prompts, [4, 8, 4, 8, 6]


@pytest.mark.parametrize("kv", KVS, ids=KV_IDS)
@pytest.mark.parametrize("lane", LANES)
def test_schedulers_match_reference(lane, kv):
    """Both of the port's unchunked schedulers against the reference
    dense-cache scheduler: tokens, admission and finish steps, counters.
    The paged one (no compaction anywhere, sanitizer armed) matches it
    step for step, as the reference's paged scheduler does."""
    rc, tc = _cfgs(lane, kv)
    rp, tp = _params(lane)
    prompts, gens = _workload(tc)
    ref = RefScheduler(RefEngine(rc, rp, max_len=32), n_slots=2, chunk_size=4)
    want = _run(ref, prompts, gens)

    dense = Scheduler(Engine(tc, tp, max_len=32, device="cpu"), n_slots=2,
                      chunk_size=4)
    _same_completions(_run(dense, prompts, gens), want)
    for name in COUNTERS:
        assert dense.stats[name] == ref.stats[name], name
    assert "peak_committed" not in dense.stats
    assert (dense.cache["lens"] == 0).all() and not dense.leak_report()

    paged = Scheduler(Engine(tc, tp, max_len=32, paged=True, block_size=4,
                             sanitize=True, device="cpu"), n_slots=2, chunk_size=4)
    _same_completions(_run(paged, prompts, gens), want)
    assert paged.pool.in_use == 0 and paged._outstanding == 0
    assert paged.n_leaked == 0 and not paged.leak_report()
    assert paged.pool.n_sanitizer_checks > 0


@pytest.mark.parametrize("lane", LANES)
def test_paged_scheduler_counters_match_reference(lane):
    """The reference's own unchunked paged scheduler on a pool below the
    worst case: tokens, steps, block peaks and the arena's high-water mark
    equal, and the port's arena smaller than its dense pool."""
    rc, tc = _cfgs(lane)
    rp, tp = _params(lane)
    prompts, gens = _workload(tc)
    nb = 10 if lane != "window" else 0
    ref = RefScheduler(RefEngine(rc, rp, max_len=32, paged=True, block_size=4,
                                 n_blocks=nb), n_slots=2, chunk_size=4)
    want = _run(ref, prompts, gens)
    port = Scheduler(Engine(tc, tp, max_len=32, paged=True, block_size=4,
                            n_blocks=nb, device="cpu"), n_slots=2, chunk_size=4)
    _same_completions(_run(port, prompts, gens), want)
    for name in COUNTERS + ("peak_committed", "peak_logical"):
        assert port.stats[name] == ref.stats[name], name
    assert port.pool.peak_in_use == ref.pool.peak_in_use
    dense = Scheduler(Engine(tc, tp, max_len=32, device="cpu"), n_slots=2,
                      chunk_size=4)
    if lane != "window":
        assert kvc.cache_report(port.cache)["bytes"] < \
            kvc.cache_report(dense.cache)["bytes"]


def test_token_identity_under_forced_compaction(monkeypatch):
    """A ``max_len`` tight enough that the shared frontier is pulled back
    between quanta: tokens and steps equal the reference's, and the
    frontier did move backwards."""
    rc, tc = _cfgs("dense", "posit16")
    rp, tp = _params("dense")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, tc.vocab, n).tolist() for n in (5, 9, 3, 7, 4, 6)]
    gens = [6, 12, 4, 9, 5, 7]
    ref = RefScheduler(RefEngine(rc, rp, max_len=24), n_slots=3, chunk_size=4)
    want = _run(ref, prompts, gens)
    moves = []
    compact = kvc.compact

    def counted(cache, target_len=None):
        moves.append((int(cache["len"]), int(target_len)))
        return compact(cache, target_len)

    monkeypatch.setattr(kvc, "compact", counted)
    port = Scheduler(Engine(tc, tp, max_len=24, device="cpu"), n_slots=3,
                     chunk_size=4)
    _same_completions(_run(port, prompts, gens), want)
    assert any(target < cur for cur, target in moves)
    assert port.stats["n_compiles"] == ref.stats["n_compiles"]


def test_paged_scheduler_defers_admission_when_pool_is_tight():
    """A five-block pool holds about one request's worst case: admissions
    defer in FIFO order, the streams and steps equal the reference's."""
    rc, tc = _cfgs("dense")
    rp, tp = _params("dense")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, tc.vocab, n).tolist() for n in (5, 9, 3, 7)]
    gens = [4, 8, 4, 8]
    ref = RefScheduler(RefEngine(rc, rp, max_len=32, paged=True, block_size=4,
                                 n_blocks=5), n_slots=2, chunk_size=4)
    want = _run(ref, prompts, gens)
    port = Scheduler(Engine(tc, tp, max_len=32, paged=True, block_size=4,
                            n_blocks=5, device="cpu"), n_slots=2, chunk_size=4)
    _same_completions(_run(port, prompts, gens), want)
    assert port.pool.peak_in_use <= 5
    assert any(c.admitted_step > 0 for c in want)
    with pytest.raises(ValueError, match="block"):
        port.submit(list(range(1, 13)), 8)    # needs ceil(23/4) = 6 > 5


def _eos_case():
    """A prompt whose reference greedy stream has a token first seen at
    index 2; returns (prompt, stream)."""
    rc, tc = _cfgs("dense")
    rp, _ = _params("dense")
    eng = RefEngine(rc, rp, max_len=32)
    for seed in range(5, 40):
        prompt = np.random.default_rng(seed).integers(1, tc.vocab, 6).tolist()
        stream = eng.generate([prompt], 8).tokens[0].tolist()
        if stream[2] not in stream[:2]:
            return prompt, stream
    raise AssertionError("no prompt with a fresh third greedy token")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_eos_stops_early_and_frees_the_slot(paged):
    """``eos_id`` = the token first seen at index 2 of the greedy stream:
    the stream stops there, the slot is retired, and the queued request
    behind it in a one-slot pool then runs in full.  ``eos_id`` = the
    first token: the request finishes on its prefill token."""
    _, tc = _cfgs("dense")
    _, tp = _params("dense")
    prompt, stream = _eos_case()
    for eos, n in ((stream[2], 3), (stream[0], 1)):
        sched = Scheduler(Engine(tc, tp, max_len=32, paged=paged, block_size=4,
                                 device="cpu"), n_slots=1, chunk_size=4)
        rid = sched.submit(prompt, 8, eos_id=eos)
        rid2 = sched.submit(prompt, 8)
        done = sched.run(max_rounds=50)
        assert done[rid].tokens.tolist() == stream[:n]
        assert done[rid2].tokens.tolist() == stream
        assert done[rid2].admitted_step >= done[rid].finished_step
        if n == 1:
            assert done[rid].finished_step == 0     # no decode quantum ran


def test_scheduler_mode_checks_match_reference():
    _, tc = _cfgs("dense")
    _, tp = _params("dense")
    eng = Engine(tc, tp, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="paged=True"):
        Scheduler(eng, n_slots=2, chunked_prefill=True)
    with pytest.raises(ValueError, match="paged=True"):
        Scheduler(eng, n_slots=2, prefix_cache=True)
    sched = Scheduler(eng, n_slots=2, chunk_size=4)
    assert not (sched.paged or sched.chunked)
    pag = Scheduler(Engine(tc, tp, max_len=32, paged=True, block_size=4,
                           device="cpu"), n_slots=2, chunk_size=4)
    assert pag.paged and not pag.chunked
    with pytest.raises(ValueError, match="max_len"):
        sched.submit(list(range(1, 30)), 8)


def _load_chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["minicpm3-4b-dense", "phi3-medium-14b-unchunked"])
def test_chip_smoke_unchunked_schedules(monkeypatch, name):
    """``chip_smoke.py`` fails unless its dense-cache and unchunked paged
    paths run the schedules it pins (rounds, decode steps, compactions,
    admission steps).  Without EOS a schedule depends on the trace, the
    pool and the cache geometry, never on the model's tokens, so it is
    pinned here with the model stubbed out: the prefill returns an empty
    cache of the prompt's frontier, a decode step only advances it, and
    the caches' features are one wide."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.runtime import engine as E

    smoke = _load_chip_smoke()
    argv, _ = smoke.LINEAR_PATHS[name]
    argv = [a if a != "cuda" else "cpu" for a in argv]

    def init_cache(cfg, batch, max_len, window_ring=True, *, device="cuda"):
        lead = (1, batch, max_len, 1)
        return {**{k: torch.zeros(lead) for k in T.arena_keys(cfg)},
                **T._cache_meta(batch, 0, max_len, device=device)}

    def init_paged_cache(cfg, batch, max_len, block_size, n_blocks, *, device="cuda"):
        w = T.paged_table_width(cfg, block_size, max_len)
        return {**{k: torch.zeros((1, n_blocks, block_size, 1)) for k in T.arena_keys(cfg)},
                "block_tables": torch.full((batch, w), n_blocks, dtype=torch.int32),
                "lens": torch.zeros((batch,), dtype=torch.int32), "max_len": int(max_len)}

    def prefill(params, tokens, cfg, visual=None, *, max_len=None, **kw):
        cache = dict(init_cache(cfg, tokens.shape[0], max_len, device="cpu"),
                     len=tokens.shape[1])
        cache["lens"] = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32)
        return cache, torch.zeros((tokens.shape[0], cfg.vocab))

    def step(self, cache, tok, active=None):
        adv = torch.ones_like(cache["lens"]) if active is None else active.to(torch.int32)
        out = dict(cache, lens=cache["lens"] + adv)
        if "len" in cache:
            out["len"] = cache["len"] + 1
        return torch.zeros((tok.shape[0], self.cfg.vocab)), out

    compactions = [0]
    compact = kvc.compact

    def counted(*a, **kw):
        compactions[0] += 1
        return compact(*a, **kw)

    monkeypatch.setattr(T, "init_params", lambda cfg, **kw: {"tok_embed": torch.zeros(1)})
    monkeypatch.setattr(T, "init_cache", init_cache)
    monkeypatch.setattr(T, "init_paged_cache", init_paged_cache)
    monkeypatch.setattr(T, "prefill", prefill)
    monkeypatch.setattr(E.Engine, "_step", step)
    monkeypatch.setattr(kvc, "compact", counted)
    res = serve.main(argv)
    assert len(res.done) == 16 and not res.sched.leak_report()
    assert smoke.schedule_of(res, compactions[0]) == smoke.SCHEDULES[name]
    if res.sched.paged:
        assert res.sched.pool.in_use == 0
    else:
        assert compactions[0] > 0
