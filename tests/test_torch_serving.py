"""The port's serving stack against the reference, end to end.

One seeded Poisson trace runs through the port's chunked paged posit16
``Scheduler`` (fused decode; on the CPU its plain version) and through
the reference ``Scheduler`` (chunked, paged, posit16, the ``gather``
decode path -- the reference's own tests pin fused == gather, and
Pallas interpret mode is slow).  Greedy token streams must be identical
per request on the dense and sliding-window lanes, the port's block
pool must end with every block free, and its dispatch count must stay
flat across the trace's prompt lengths.  The MLA lane (reduced
minicpm3-4b) runs the same trace; its engine takes the dense table
width, never the window ring.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro import configs as RCFG
from repro.launch.serve import drive_trace as ref_drive_trace
from repro.models import get_family
from repro.runtime.engine import Engine as RefEngine
from repro.runtime.scheduler import Scheduler as RefScheduler
from repro_torch import configs as TCFG
from repro_torch.launch.serve import drive_trace, poisson_trace
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import Scheduler
from repro_torch.weights import params_from_jax

MAX_LEN, BS, CHUNK, SLOTS = 40, 4, 4, 3


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfgs(lane):
    arch = "minicpm3-4b" if lane == "mla" else "phi3-medium-14b"
    rc = RCFG.get_config(arch).reduced(compute_dtype="float32",
                                       kv_posit="posit16")
    tc = TCFG.get_config(arch).reduced(compute_dtype="float32",
                                       kv_posit="posit16")
    if lane == "window":
        rc = dataclasses.replace(rc, sliding_window=8, attn_chunk_kv=8)
        tc = dataclasses.replace(tc, sliding_window=8, attn_chunk_kv=8)
    return rc, tc


@pytest.mark.parametrize("lane", ["dense", "window", "mla"])
def test_scheduler_tokens_match_reference(lane):
    rc, tc = _cfgs(lane)
    rp = get_family(rc).init_params(jax.random.PRNGKey(0), rc)
    tp = params_from_jax(jax.tree.map(np.asarray, rp), tc, device="cpu")
    trace = poisson_trace(np.random.default_rng(1), 8, 0.5, tc.vocab, 20, 10)

    ref = RefScheduler(
        RefEngine(rc, rp, max_len=MAX_LEN, paged=True, block_size=BS,
                  decode_kernel="gather"),
        n_slots=SLOTS, chunk_size=CHUNK, chunked_prefill=True)
    ref_done, ref_order = ref_drive_trace(ref, trace)

    sched = Scheduler(
        Engine(tc, tp, max_len=MAX_LEN, paged=True, block_size=BS,
               decode_kernel="fused", device="cpu"),
        n_slots=SLOTS, chunk_size=CHUNK, chunked_prefill=True)
    done, order = drive_trace(sched, trace)

    want = {ref_order[r]: c.tokens.tolist() for r, c in ref_done.items()}
    got = {order[r]: c.tokens.tolist() for r, c in done.items()}
    assert got == want
    assert sched.pool.n_free == sched.n_blocks and sched.pool.in_use == 0
    assert sched.stats["n_compiles"] == 1
    assert sched.n_admitted == sched.n_retired == len(trace)
    assert (sched.cache["block_tables"] == sched.n_blocks).all()
    assert (sched.cache["lens"] == 0).all()


@pytest.mark.parametrize("lane", ["dense", "window"])
def test_engine_block_allocation_matches_reference(lane):
    rc, tc = _cfgs(lane)
    rp = get_family(rc).init_params(jax.random.PRNGKey(0), rc)
    tp = params_from_jax(jax.tree.map(np.asarray, rp), tc, device="cpu")
    ref = RefEngine(rc, rp, max_len=MAX_LEN, paged=True, block_size=BS)
    eng = Engine(tc, tp, max_len=MAX_LEN, paged=True, block_size=BS,
                 device="cpu")
    assert (eng.table_width, eng.window_lane) == \
        (ref.table_width, ref.window_lane)
    lens = [5, 17, 1, 30]
    for reserve in (0, 6, 40):
        assert [eng._row_blocks_needed(n, reserve) for n in lens] == \
            [ref._row_blocks_needed(n, reserve) for n in lens]
        nb = len(lens) * eng.table_width
        got, pool = eng._alloc_tables(lens, reserve, nb)
        want, ref_pool = ref._alloc_tables(lens, reserve, nb)
        np.testing.assert_array_equal(got, want)
        assert pool.in_use == ref_pool.in_use


def test_mla_engine_takes_the_dense_table_width():
    """MLA has no window: even with ``sliding_window`` set, the engine's
    table is the dense ``ceil(max_len / block_size)``, as the
    reference's is."""
    rc, tc = _cfgs("mla")
    rc = dataclasses.replace(rc, sliding_window=8)
    tc = dataclasses.replace(tc, sliding_window=8)
    rp = get_family(rc).init_params(jax.random.PRNGKey(0), rc)
    tp = params_from_jax(jax.tree.map(np.asarray, rp), tc, device="cpu")
    ref = RefEngine(rc, rp, max_len=MAX_LEN, paged=True, block_size=BS)
    eng = Engine(tc, tp, max_len=MAX_LEN, paged=True, block_size=BS,
                 device="cpu")
    assert (eng.table_width, eng.window_lane) == \
        (ref.table_width, ref.window_lane) == (MAX_LEN // BS, False)
    cache = eng.init_cache(2)
    assert set(cache) >= {"c_kv", "k_rope"} and "k" not in cache
    assert cache["block_tables"].shape == (2, MAX_LEN // BS)
