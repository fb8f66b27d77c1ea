"""The port's prefix cache, EDF deadlines and preemption against the
reference scheduler, on the dense, MLA and sliding-window lanes.

Mirrors ``tests/test_prefix.py`` and the policy tests of
``tests/test_scheduler.py``.  Both schedulers run the same prompts with
f32 KV (chunked prefill is then bitwise whole-prompt prefill, so prefix
sharing cannot change a token) under the arena sanitizer; the reference
decodes through its ``gather`` path (its own tests pin fused == gather),
the port through its fused wrapper (on the CPU the plain version).
Greedy token streams must be identical per request, and the scheduling
counters (prefix hits, copy-on-write copies, evictions, preemptions,
admission steps, physical and logical block peaks) equal the
reference's.  No block may leak.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as RCFG
from repro.compress import kvcache as RKV
from repro.models import get_family
from repro.models import layers as RL
from repro.runtime.engine import Engine as RefEngine
from repro.runtime.scheduler import Scheduler as RefScheduler
from repro_torch import configs as TCFG
from repro_torch.compress import kvcache as kvc
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import Scheduler
from repro_torch.weights import params_from_jax

LANES = ["dense", "mla", "window"]
COUNTERS = ("prefix_hits", "prefix_matched_tokens", "prefill_tokens",
            "n_cow", "n_evicted", "n_preempted", "peak_committed",
            "peak_logical")


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfgs(lane):
    arch = "minicpm3-4b" if lane == "mla" else "phi3-medium-14b"
    rc = RCFG.get_config(arch).reduced(compute_dtype="float32")
    tc = TCFG.get_config(arch).reduced(compute_dtype="float32")
    if lane == "window":
        rc = dataclasses.replace(rc, sliding_window=8, attn_chunk_kv=8)
        tc = dataclasses.replace(tc, sliding_window=8, attn_chunk_kv=8)
    return rc, tc


_PARAMS = {}


def _params(lane):
    if lane not in _PARAMS:
        rc, tc = _cfgs(lane)
        rp = get_family(rc).init_params(jax.random.PRNGKey(0), rc)
        _PARAMS[lane] = (rp, params_from_jax(jax.tree.map(np.asarray, rp),
                                             tc, device="cpu"))
    return _PARAMS[lane]


def _schedulers(lane, *, bs, nb, max_len, n_slots, chunk, prefix_cache=True,
                sanitize=True):
    rc, tc = _cfgs(lane)
    rp, tp = _params(lane)
    ref = RefScheduler(
        RefEngine(rc, rp, max_len=max_len, paged=True, block_size=bs,
                  n_blocks=nb, sanitize=sanitize, decode_kernel="gather"),
        n_slots=n_slots, chunk_size=chunk, prefix_cache=prefix_cache,
        chunked_prefill=True)
    port = Scheduler(
        Engine(tc, tp, max_len=max_len, paged=True, block_size=bs, n_blocks=nb,
               sanitize=sanitize, decode_kernel="fused", device="cpu"),
        n_slots=n_slots, chunk_size=chunk, prefix_cache=prefix_cache,
        chunked_prefill=True)
    return ref, port


def _drive(sched, prompts, max_new, warm):
    """Run ``warm`` donors to completion first (prefix blocks register
    when a prompt finishes its chunks), then the rest."""
    done = {}
    rids = [sched.submit(p, max_new) for p in prompts[:warm]]
    done.update(sched.run(max_rounds=500))
    rids += [sched.submit(p, max_new) for p in prompts[warm:]]
    done.update(sched.run(max_rounds=500))
    return [done[r].tokens.tolist() for r in rids], \
        [done[r].admitted_step for r in rids]


def _assert_like_reference(ref, port, ref_out, port_out):
    assert port_out == ref_out
    for name in COUNTERS:
        assert getattr(port, name) == getattr(ref, name), name
    assert port.n_leaked == 0 and not port.leak_report()
    assert not ref.leak_report()


def _lane_trace(lane, rng):
    """Shared-prefix prompts sized to each lane's sharing regime (window
    sharing needs the whole prompt inside the window)."""
    if lane == "window":
        shared = [int(t) for t in rng.integers(0, 200, 6)]
        prompts = [shared + [int(t) for t in rng.integers(0, 200, 2)]
                   for _ in range(4)]
        return prompts, dict(max_new=10, bs=2, nb=64, max_len=64)
    shared = [int(t) for t in rng.integers(0, 200, 40)]
    prompts = [shared + [int(t) for t in rng.integers(0, 200, 6)]
               for _ in range(4)]
    return prompts, dict(max_new=12, bs=8, nb=128, max_len=96)


# ---------------------------------------------------------------------------
# prefix_block_hashes and PrefixIndex
# ---------------------------------------------------------------------------

def test_prefix_hashes_match_reference_and_chain_full_blocks():
    toks = list(range(10))
    for seq in (toks, [99] + toks[1:], toks[:4] + [7] * 6, toks[:3]):
        assert kvc.prefix_block_hashes(seq, 4) == \
            RKV.prefix_block_hashes(seq, 4)
    hs = kvc.prefix_block_hashes(toks, 4)
    assert len(hs) == 2                 # the partial third block: no hash
    other = kvc.prefix_block_hashes([99] + toks[1:], 4)
    assert other[0] != hs[0] and other[1] != hs[1]
    mixed = kvc.prefix_block_hashes(toks[:4] + [7] * 6, 4)
    assert mixed[0] == hs[0] and mixed[1] != hs[1]


def test_prefix_index_lru_and_first_writer_wins():
    idx = kvc.PrefixIndex()
    assert idx.put("a", 1) and idx.put("b", 2)
    assert not idx.put("a", 3)          # first writer wins
    with pytest.raises(ValueError):
        idx.put("c", 1)                 # one hash per block
    assert idx.get("a") == 1            # bumps "a" to most recent
    assert idx.blocks_lru() == [2, 1]
    assert idx.pop_block(2) == "b"
    assert idx.get("b") is None and len(idx) == 1


@pytest.mark.parametrize("posit", [False, True], ids=["f32", "posit16"])
def test_copy_and_poison_blocks_match_reference(posit):
    rng = np.random.default_rng(4)
    nb = 6
    arena = rng.integers(0, 1 << 16, (2, nb, 4, 3))
    arena = arena.astype(np.uint16) if posit else arena.astype(np.float32)
    src, dst = [1, 4, nb], [3, nb, 5]   # a sentinel on either side
    ref = np.asarray(RL.paged_copy_blocks(jnp.asarray(arena),
                                          jnp.asarray(src, jnp.int32),
                                          jnp.asarray(dst, jnp.int32)))
    got = L.paged_copy_blocks(torch.from_numpy(arena.copy()), src, dst)
    np.testing.assert_array_equal(got.numpy(), ref)
    ref = np.asarray(RL.paged_poison_blocks(jnp.asarray(arena),
                                            jnp.asarray([0, 2, nb], jnp.int32)))
    got = L.paged_poison_blocks(torch.from_numpy(arena.copy()), [0, 2, nb])
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# prefix caching end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lane", LANES)
def test_prefix_sharing_matches_reference(lane):
    """Requests borrowing a shared prefix emit the reference's tokens and
    the port's own non-sharing streams, with the reference's counters;
    on the window lane ring recycling copies shared blocks first."""
    prompts, kw = _lane_trace(lane, np.random.default_rng(3))
    max_new = kw.pop("max_new")
    ref, port = _schedulers(lane, n_slots=2, chunk=4, **kw)
    ref_out = _drive(ref, prompts, max_new, warm=1)
    port_out = _drive(port, prompts, max_new, warm=1)
    _assert_like_reference(ref, port, ref_out, port_out)
    _, base = _schedulers(lane, n_slots=2, chunk=4, prefix_cache=False, **kw)
    assert _drive(base, prompts, max_new, warm=1)[0] == port_out[0]
    assert port.prefix_hits >= len(prompts) - 1
    assert port.prefill_tokens < base.prefill_tokens
    if lane == "window":
        assert port.n_cow > 0
    else:
        assert port.peak_committed < base.peak_committed


def test_exact_duplicate_prompts_trigger_admission_cow():
    """A block-aligned full-prompt match still reruns its last token,
    whose write lands in a copy of the boundary block."""
    rng = np.random.default_rng(5)
    p0 = [int(t) for t in rng.integers(0, 200, 24)]       # 24 % 4 == 0
    ref, port = _schedulers("dense", bs=4, nb=64, max_len=64, n_slots=2,
                            chunk=4)
    ref_out = _drive(ref, [p0, list(p0), list(p0)], 8, warm=1)
    port_out = _drive(port, [p0, list(p0), list(p0)], 8, warm=1)
    _assert_like_reference(ref, port, ref_out, port_out)
    assert port.n_cow >= 2


def test_prefix_eviction_under_pressure_matches_reference():
    """Three prefix families on a tight pool: admissions evict index-only
    blocks oldest first; the drained pool holds exactly the index's
    references."""
    rng = np.random.default_rng(11)
    fams = [[int(t) for t in rng.integers(0, 200, 24)] for _ in range(3)]
    prompts = [fams[i % 3] + [int(t) for t in rng.integers(0, 200, 5)]
               for i in range(9)]
    ref, port = _schedulers("dense", bs=4, nb=24, max_len=64, n_slots=2,
                            chunk=4)
    ref_out = _drive(ref, prompts, 8, warm=0)
    port_out = _drive(port, prompts, 8, warm=0)
    _assert_like_reference(ref, port, ref_out, port_out)
    assert port.n_evicted > 0
    assert port.pool.in_use == len(port.index)
    assert all(port.pool.refcount(b) == 1 for b in port.index.blocks_lru())


def test_sanitizer_catches_skipped_window_cow(monkeypatch):
    """With the window lane's pre-round copy pass disabled, the decode
    round would write through a shared block: the sanitizer's write gate
    raises before the write."""
    prompts, kw = _lane_trace("window", np.random.default_rng(3))
    max_new = kw.pop("max_new")
    _, port = _schedulers("window", n_slots=2, chunk=4, **kw)
    monkeypatch.setattr(Scheduler, "_cow_window_rows", lambda self: False)
    with pytest.raises(kvc.BlockSanitizerError, match="COW violation"):
        _drive(port, prompts, max_new, warm=1)


# ---------------------------------------------------------------------------
# EDF admission and preemption
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lane", LANES)
def test_edf_admission_order_matches_reference(lane):
    """A one-slot pool admits by earliest deadline; best-effort last."""
    rc, _ = _cfgs(lane)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(1, rc.vocab, 5).tolist() for _ in range(3)]
    admitted = []
    for sched in _schedulers(lane, bs=4, nb=32, max_len=32, n_slots=1,
                             chunk=4, prefix_cache=False):
        rids = [sched.submit(prompts[0], 4),
                sched.submit(prompts[1], 4, deadline=100),
                sched.submit(prompts[2], 4, deadline=50)]
        done = sched.run(max_rounds=200)
        admitted.append([done[r].admitted_step for r in rids])
        assert done[rids[2]].admitted_step < done[rids[1]].admitted_step \
            < done[rids[0]].admitted_step
    assert admitted[1] == admitted[0]


@pytest.mark.parametrize("lane", LANES)
def test_preemption_restores_tokens_and_leaks_nothing(lane):
    """A deadline request that cannot fit preempts the best-effort row
    (its blocks released and poisoned); the restarted request emits the
    reference's tokens and no block leaks."""
    rc, _ = _cfgs(lane)
    rng = np.random.default_rng(15)
    p_a = rng.integers(1, rc.vocab, 8).tolist()
    p_b = rng.integers(1, rc.vocab, 8).tolist()
    nb = 6 if lane != "window" else 4    # one resident request at a time
    scheds = _schedulers(lane, bs=4, nb=nb, max_len=32, n_slots=2, chunk=4,
                         prefix_cache=False)
    out = []
    for sched in scheds:
        ra = sched.submit(p_a, 8)
        sched.step()
        rb = sched.submit(p_b, 8, deadline=20)
        done = sched.run(max_rounds=300)
        assert sched.n_preempted >= 1
        assert done[rb].admitted_step < done[ra].admitted_step
        out.append(([done[r].tokens.tolist() for r in (ra, rb)],
                    [done[r].admitted_step for r in (ra, rb)],
                    sched.n_preempted))
    assert out[1] == out[0]
    assert scheds[1].n_leaked == 0 and not scheds[1].leak_report()


def test_best_effort_never_preempts_best_effort():
    """Without deadlines the same overload queues: no preemption, FIFO."""
    rc, _ = _cfgs("dense")
    rng = np.random.default_rng(16)
    p_a = rng.integers(1, rc.vocab, 8).tolist()
    p_b = rng.integers(1, rc.vocab, 8).tolist()
    _, port = _schedulers("dense", bs=4, nb=6, max_len=32, n_slots=2,
                          chunk=4, prefix_cache=False)
    ra = port.submit(p_a, 8)
    port.step()
    rb = port.submit(p_b, 8)
    done = port.run(max_rounds=300)
    assert port.n_preempted == 0
    assert done[rb].admitted_step >= done[ra].finished_step
    assert port.n_leaked == 0 and not port.leak_report()


def test_serve_cli_prefix_cache_and_deadlines():
    """The launcher's prefix-cache and deadline path at reduced width:
    mixed interactive (deadline) and best-effort traffic on a tight pool
    gives prefix hits and preemptions, every request completes, and the
    drained pool holds only the prefix index's blocks."""
    res = serve.main([
        "--arch", "minicpm3-4b", "--reduced", "--device", "cpu",
        "--continuous", "--paged", "--chunked-prefill", "--kv-posit",
        "posit16", "--decode-kernel", "fused", "--batch", "4", "--n-requests", "8", "--prompt-len", "24",
        "--gen", "8", "--chunk-size", "4", "--block-size", "4",
        "--prefix-cache", "--prefix-share", "0.5", "--deadline-ms", "200",
        "--deadline-share", "0.5", "--n-blocks", "24"])
    sched = res.sched
    assert len(res.done) == 8
    assert sched.prefix_hits > 0 and sched.n_preempted > 0
    assert not sched.leak_report()
    assert sched.pool.in_use == len(sched.index)
    assert all(len(c.tokens) > 0 for c in res.done.values())


def _load_chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_mla_schedule_hits_prefix_and_preempts(monkeypatch):
    """``chip_smoke.py`` fails unless its minicpm3-4b path shows prefix
    hits and preemptions.  The schedule depends on the trace and the
    pool, never on the model's tokens (no EOS), so it is pinned here on
    the CPU with the model stubbed out of ``Engine.mixed_step``: 47
    rounds, 288 decode steps, 9 prefix hits, 3 preemptions."""
    from repro_torch.models import transformer as T

    argv, _ = _load_chip_smoke().MAIN_PATHS["minicpm3-4b"]
    argv = [a if a != "cuda" else "cpu" for a in argv]
    decode_steps = [0]

    def mixed_step(self, cache, chunk_tokens, n_valid, tokens, n_steps, *,
                   decode_active=None, write_tables=None):
        act = torch.as_tensor(np.asarray(decode_active), dtype=torch.int32)
        decode_steps[0] += int(n_steps) if bool(act.any()) else 0
        lens = cache["lens"] + torch.as_tensor(np.asarray(n_valid)) \
            + act * int(n_steps)
        b = lens.shape[0]
        return (dict(cache, lens=lens.to(torch.int32)),
                torch.zeros((b, 1)), torch.ones((b, int(n_steps)),
                                                dtype=torch.int64))

    def arena(cfg, batch, max_len, block_size, n_blocks, *, device="cuda"):
        w = T.paged_table_width(cfg, block_size, max_len)
        return {"c_kv": torch.zeros((1, n_blocks, 1, 1)),
                "k_rope": torch.zeros((1, n_blocks, 1, 1)),
                "block_tables": torch.full((batch, w), n_blocks,
                                           dtype=torch.int32),
                "lens": torch.zeros((batch,), dtype=torch.int32),
                "max_len": int(max_len)}

    monkeypatch.setattr(Engine, "mixed_step", mixed_step)
    monkeypatch.setattr(T, "init_paged_cache", arena)
    monkeypatch.setattr(T, "init_params", lambda cfg, **kw: {
        "tok_embed": torch.zeros(1)})
    res = serve.main(argv)
    sched = res.sched
    assert len(res.done) == 16
    assert (sched.n_chunks, decode_steps[0]) == (47, 288)
    assert (sched.prefix_hits, sched.n_preempted) == (9, 3)
    assert not sched.leak_report()
    assert sched.pool.in_use == len(sched.index)
