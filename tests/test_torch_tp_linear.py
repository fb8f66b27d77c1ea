"""Tensor-parallel serving on linear caches, on gloo ranks on the CPU,
against the reference's single-device run.

The one-shot engine and the dense-cache scheduler under a rank mesh
(``Engine(mesh=)`` without ``paged``): the port's ranks
(``launch/mesh.spawn``, one process each, gloo; the rank code in
``tests/tp_linear.py``) are held to the reference's single-device JAX
run on the same weights (``weights.params_from_jax``; biases, norms and
per-head vectors drawn from a seed, ``tp_linear.perturb``), reduced
configs in f32 with posit16 KV.  One-shot, at mp 2 on the dense, window
(``sliding_window=8``, a ring the prompts overrun), MLA, MQA, MoE,
tied-embedding and visual-prefix lanes, and at mp 4 on the dense lane,
whose 2 KV heads do not divide: greedy tokens equal to the reference's,
``generate_stepwise`` equal to ``generate`` bit for bit, prefill logits
within 1e-4 (``tests/test_torch_engine.py``'s tolerance), every rank's
tokens identical, and ``cache_report``'s ``per_device_bytes`` the split
share (the K/V leaves over mp where the KV heads split; MQA's one KV
head and MLA's latents whole).  The dense-cache scheduler at mp 2 on
the dense and MLA lanes: tokens, admission and finish steps and the
frontier's moves (compactions, at least one) equal.  At temperature
0.7 with a different seed on each rank, every rank emits rank 0's
draws.  One spawn a mesh size; the reference runs while the ranks do.
"""
import concurrent.futures

import numpy as np
import pytest

import jax

import tp_linear as TL
from repro import configs as RCFG
from repro.models import get_family
from repro.runtime.engine import Engine as RefEngine
from repro.runtime.scheduler import Scheduler as RefScheduler
from repro_torch.launch import mesh as M

ONESHOT2 = ["dense", "window", "mla", "mqa", "moe", "tied", "visual"]
# at mp 4 the heads of these lanes do not split: context-parallel prefill
ONESHOT4 = ["dense", "window", "mla6", "visual"]
DENSE2 = ["dense-sched", "mla-sched"]
DENSE4 = ["dense-sched", "mla6-sched"]
SPAWN_TIMEOUT = 300
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def runs():
    lanes = ONESHOT2 + ONESHOT4 + DENSE2 + DENSE4
    np_params, ref_params = {}, {}
    for lane in lanes:
        key = TL.param_key(lane)
        if key not in np_params:
            rc = TL.lane_config(RCFG, lane)
            raw = get_family(rc).init_params(jax.random.PRNGKey(0), rc)
            np_params[key] = TL.perturb(jax.tree.map(np.asarray, raw))
            ref_params[key] = jax.tree.map(jax.numpy.asarray, np_params[key])
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        mp2 = pool.submit(M.spawn, TL.rank_run, ["cpu"] * 2,
                          ({"oneshot": ONESHOT2, "dense": DENSE2, "sampled": True},
                           np_params, 2), timeout=SPAWN_TIMEOUT, threads=1)
        mp4 = pool.submit(M.spawn, TL.rank_run, ["cpu"] * 4,
                          ({"oneshot": ONESHOT4, "dense": DENSE4}, np_params, 4),
                          timeout=SPAWN_TIMEOUT, threads=1)
        ref = {}
        for lane in dict.fromkeys(ONESHOT2 + ONESHOT4):
            rc = TL.lane_config(RCFG, lane)
            prompts, kw = TL.inputs(rc, lane)
            res = RefEngine(rc, ref_params[TL.param_key(lane)], max_len=TL.MAX_LEN).generate(
                prompts, TL.GEN, **{k: jax.numpy.asarray(v) for k, v in kw.items()})
            ref[lane] = {"tokens": np.asarray(res.tokens).tolist(),
                         "logits": np.asarray(res.prefill_logits)}
        for lane in dict.fromkeys(DENSE2 + DENSE4):
            rc = TL.lane_config(RCFG, lane)
            ref[lane] = TL.run_dense(RefScheduler(
                RefEngine(rc, ref_params[TL.param_key(lane)], max_len=TL.SCHED["max_len"]),
                n_slots=TL.SCHED["n_slots"], chunk_size=TL.SCHED["chunk_size"]))
        return {"ref": ref, 2: mp2.result(), 4: mp4.result()}


CASES = [(lane, 2) for lane in ONESHOT2] + [(lane, 4) for lane in ONESHOT4]
IDS = [f"{lane}-mp{mp}" for lane, mp in CASES]


@pytest.mark.parametrize("lane,mp", CASES, ids=IDS)
def test_oneshot_matches_reference(runs, lane, mp):
    want = runs["ref"][lane]
    for rank, got in enumerate(r[lane] for r in runs[mp]):
        assert got["tokens"] == want["tokens"], rank
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("lane,mp", CASES, ids=IDS)
def test_stepwise_equals_generate_under_a_mesh(runs, lane, mp):
    for got in (r[lane] for r in runs[mp]):
        assert got["stepwise"] == got["tokens"]
        assert got["tokens"] == runs[mp][0][lane]["tokens"]


@pytest.mark.parametrize("lane,mp", CASES, ids=IDS)
def test_per_device_bytes_are_the_split_share(runs, lane, mp):
    """``bytes`` counts the whole cache, ``per_device_bytes`` each split
    leaf's share and every other leaf whole: K/V split where the KV heads
    divide (not MQA's one head, not MLA's latents, not 2 heads at mp 4),
    and the rank-local config is that share's."""
    cfg = TL.lane_config(RCFG, lane)
    split = cfg.n_kv_heads % mp == 0 and not cfg.mla and cfg.n_kv_heads > 1
    for got in (r[lane] for r in runs[mp]):
        rep, leaf = got["report"], got["leaf_bytes"]
        assert set(got["shards"]) == ({"k", "v"} if split else set())
        assert rep["per_device_bytes"] == sum(leaf.values())
        assert rep["bytes"] == sum(b * got["shards"].get(k, 1) for k, b in leaf.items())
        if split:
            kv = leaf["k"] + leaf["v"]
            assert rep["per_device_bytes"] == rep["bytes"] - kv * (mp - 1)
            assert got["local"][1] == cfg.n_kv_heads // mp
        else:
            assert rep["per_device_bytes"] == rep["bytes"]


DENSE_CASES = [(lane, 2) for lane in DENSE2] + [(lane, 4) for lane in DENSE4]


@pytest.mark.parametrize("lane,mp", DENSE_CASES,
                         ids=[f"{ln}-mp{mp}" if mp != 2 else ln for ln, mp in DENSE_CASES])
def test_dense_cache_scheduler_matches_reference(runs, lane, mp):
    want = runs["ref"][lane]
    assert len(want["moves"]) >= 1
    assert any(b < a for a, b in want["moves"])       # a pull-back, not only raises
    cfg = TL.lane_config(RCFG, lane)
    for rank, got in enumerate(r[lane] for r in runs[mp]):
        for key in ("tokens", "admitted", "finished", "moves"):
            assert got[key] == want[key], (rank, key)
        assert got["lens"] == [0] * TL.SCHED["n_slots"]
        if not cfg.mla:
            g = cfg.n_kv_heads
            assert got["local_kv"] == (g // mp if g % mp == 0 else g,) * 2


@pytest.mark.parametrize("lane,mp", CASES + DENSE_CASES,
                         ids=IDS + [f"{ln}-mp{mp}" for ln, mp in DENSE_CASES])
def test_context_parallel_prefill_is_pinned(runs, lane, mp):
    """At mp 4 the lanes' heads do not split and their configs keep
    ``seq_shard_activations``: every prefill's attention is
    context-parallel, one gather of its rows over ``"model"`` a layer and
    a call (a ragged prompt of 14, an uneven length at 4, and the
    dense-cache scheduler's prompts and quanta), and no decode step
    gathers; at mp 2 the heads split and nothing is gathered."""
    cfg = TL.lane_config(RCFG, lane)
    for got in (r[lane] for r in runs[mp]):
        assert got["cp"] is (mp == 4)
        calls = got["cp_calls"]
        prefills = calls["prefill"] + calls["prefill_chunk"]
        assert prefills and set(prefills) == {cfg.n_layers if mp == 4 else 0}, calls
        decodes = calls["_decode_step_paged"] + calls["_decode_step_linear"]
        assert decodes and set(decodes) == {0}, calls


def test_ranks_agree_when_sampling(runs):
    """At temperature 0.7, ranks seeded differently: every rank emits
    rank 0's draws (``Engine.sample``'s broadcast)."""
    streams = [r["sampled"] for r in runs[2]]
    assert streams[0] == streams[1]
    assert streams[0] != runs["ref"][TL.SAMPLED["lane"]]["tokens"]
