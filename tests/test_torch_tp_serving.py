"""Tensor-parallel serving on gloo ranks on the CPU against the
reference's single-device run.

The port of ``tests/test_sharded_serving.py``: that test runs the
reference's mesh engine on 8 fake devices and holds it to the
single-device scheduler; here the port's ranks (``launch/mesh.spawn``,
one process each, gloo) serve the same scripts, and every rank is held
to the reference's single-device JAX run on the same weights
(``weights.params_from_jax``): tokens and ``finished_step`` equal per
request, equal prefix hits and preemptions, no leaked block under the
sanitizer, every rank's token stream identical, and the arena's bytes
per device at the head-sharded share.  The lanes (``tp_lanes.py``): the
reference's two scripts (the prefix-cache identity run at mp 2 and 4,
the preemption run on the gather path and the fused kernel) and, at mp
2, the dense, window, MLA, MQA, MoE and tied-embedding lanes on the
chunked scheduler, the window, MLA, MQA and MoE lanes on the unchunked
paged one too; at mp 4 the dense lane, whose 2 KV heads do not divide.  The ranks' spawns run
while the reference runs, each with its own deadline and rendezvous.
Every mode runs under a mesh, and is held here too: the one-shot
engine on a linear and a paged cache (every rank's tokens the whole
model's), and ``serve --model-parallel 2`` on every ``ARCH_ID`` (the
one-shot mode, and the dense-cache scheduler on the transformer family)
against ``--model-parallel 1``.
"""
import concurrent.futures
import re

import numpy as np
import pytest
import torch

import jax

import tp_lanes
from repro import configs as RCFG
from repro.models import get_family
from repro.runtime.engine import Engine as RefEngine
from repro.runtime.scheduler import Scheduler as RefScheduler
from repro_torch import configs as TCFG
from repro_torch.launch import mesh as M
from repro_torch.launch import serve
from repro_torch.models import transformer as T

LANES2 = [lane for lane in tp_lanes.LANES if lane not in tp_lanes.CP_LANES]
SPAWN_TIMEOUT = 300


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads in this process (the ranks it spawns take one
    each, ``serve``'s a share of these two)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def runs():
    """The reference's single-device runs and the ranks' results: mp 2
    on every lane (and the sampled one), mp 4 on ``MP4``."""
    lanes = LANES2 + list(tp_lanes.CP_LANES)
    keys = {tp_lanes.param_key(lane) for lane in lanes}
    ref_params, np_params = {}, {}
    for key in sorted(keys):
        lane = next(ln for ln in lanes if tp_lanes.param_key(ln) == key)
        rc = tp_lanes.lane_config(RCFG, lane)
        ref_params[key] = get_family(rc).init_params(jax.random.PRNGKey(0), rc)
        np_params[key] = jax.tree.map(np.asarray, ref_params[key])
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        mp2 = pool.submit(M.spawn, tp_lanes.rank_lanes, ["cpu"] * 2,
                          (LANES2 + ["sampled"], np_params, 2),
                          timeout=SPAWN_TIMEOUT, threads=1)
        mp4 = pool.submit(M.spawn, tp_lanes.rank_lanes, ["cpu"] * 4,
                          (MP4, np_params, 4), timeout=SPAWN_TIMEOUT, threads=1)
        ref = {}
        for lane in lanes:           # the reference decodes on its gather path
            if lane == "preempt-fused":
                ref[lane] = ref["preempt"]
                continue
            res = tp_lanes.run_lane(lane, tp_lanes.lane_config(RCFG, lane),
                                    ref_params[tp_lanes.param_key(lane)], RefEngine,
                                    RefScheduler, decode_kernel="gather")
            res.pop("sched")
            ref[lane] = res
        return {"ref": ref, 2: mp2.result(), 4: mp4.result()}


# at mp 4: the identity script's 4 KV heads split one a rank; the dense
# lane's 2 KV heads do not divide, so its attention's heads stay whole on
# every rank, its prefill is context-parallel, and only the MLP and the
# vocabulary split; so too the context-parallel lanes
MP4 = ["identity", "dense"] + list(tp_lanes.CP_LANES)
CASES = [(lane, 2) for lane in LANES2] + [(lane, 4) for lane in MP4]


@pytest.mark.parametrize("lane,mp", CASES, ids=[f"{ln}-mp{mp}" for ln, mp in CASES])
def test_sharded_serving_matches_reference(runs, lane, mp):
    want = runs["ref"][lane]
    for rank, got in enumerate(r[lane] for r in runs[mp]):
        for key in ("tokens", "finished", "admitted", "prefix_hits", "n_preempted"):
            assert got[key] == want[key], (rank, key)
        assert got["n_leaked"] == 0 and not got["leak_report"], rank
    if lane == "identity":
        assert want["prefix_hits"] > 0                 # the prefix dedup survives
    if lane.startswith("preempt"):
        assert want["n_preempted"] > 0                 # the deadline forces a restart


@pytest.mark.parametrize("lane,mp", CASES, ids=[f"{ln}-mp{mp}" for ln, mp in CASES])
def test_arena_bytes_per_device(runs, lane, mp):
    """A head-sharded arena holds 1/mp of the KV on each rank beside the
    whole metadata; MLA's latents and MQA's one KV head replicate, and
    there only the query heads split; KV heads that do not divide keep
    the whole attention on every rank."""
    cfg = tp_lanes.lane_config(TCFG, lane)
    spec = tp_lanes.LANES[lane]
    n_slots, bs = spec["sched"]["n_slots"], spec["engine"]["block_size"]
    width = T.paged_table_width(cfg, bs, spec["engine"]["max_len"])
    meta = n_slots * width * 4 + n_slots * 4 + 4      # tables, lens, max_len
    kv_split = not cfg.mla and cfg.n_kv_heads % mp == 0
    q_split = cfg.n_heads % mp == 0 and (cfg.mla or kv_split or cfg.n_kv_heads == 1)
    for got in (r[lane] for r in runs[mp]):
        rep, (h, g) = got["report"], got["local_heads"]
        assert h == (cfg.n_heads // mp if q_split else cfg.n_heads)
        if kv_split:
            assert g == cfg.n_kv_heads // mp
            assert rep["per_device_bytes"] - meta == (rep["bytes"] - meta) // mp
        else:
            assert rep["per_device_bytes"] == rep["bytes"]
        if (lane, mp) == ("identity", 4):
            assert rep["per_device_bytes"] < rep["bytes"] / 2   # the reference's check


@pytest.mark.parametrize("lane,mp", CASES, ids=[f"{ln}-mp{mp}" for ln, mp in CASES])
def test_context_parallel_prefill_is_pinned(runs, lane, mp):
    """Where the heads do not split (the dense and context-parallel lanes
    at mp 4), every whole-prompt prefill and prefill chunk gathers its
    query rows' outputs once a layer and no decode step gathers; where
    they split, nothing is gathered."""
    cfg = tp_lanes.lane_config(TCFG, lane)
    cp = mp == 4 and lane != "identity"
    for got in (r[lane] for r in runs[mp]):
        assert got["cp"] is cp
        calls = got["cp_calls"]
        prefills = calls["prefill"] + calls["prefill_chunk"]
        assert prefills and set(prefills) == {cfg.n_layers if cp else 0}, calls
        if lane in tp_lanes.CP_LANES:
            chunked = "chunked_prefill" in tp_lanes.LANES[lane]["sched"]
            assert bool(calls["prefill_chunk"]) is chunked, calls
        assert set(calls["_decode_step_paged"]) == {0}, calls


def test_ranks_agree_when_sampling(runs):
    """At temperature > 0 every rank emits rank 0's draws."""
    streams = [r["sampled"]["tokens"] for r in runs[2]]
    assert streams[0] == streams[1]
    assert sum(len(t) for t in streams[0].values()) > 0


def test_uncovered_modes_raise_under_a_mesh(runs):
    """Every mode runs under a mesh: the one-shot
    ``generate`` on a linear engine and on a paged one gives every rank
    the tokens of the whole model on one rank."""
    for rank in runs[2]:
        modes = rank["_linear_modes"]
        want = modes[("linear", False)]
        assert modes[("paged", False)] == want
        for layout in ("linear", "paged"):
            assert modes[(layout, True)] == want, layout
        assert modes == runs[2][0]["_linear_modes"]


def test_serve_model_parallel_matches_single_rank(capfd):
    """The command line at ``--model-parallel 2`` on two CPU ranks gives
    the tokens and schedule of ``--model-parallel 1`` and prints the
    ``sharded:`` line with half the arena per device."""
    argv = ["--continuous", "--paged", "--chunked-prefill", "--kv-posit", "posit16",
            "--decode-kernel", "fused", "--prefix-cache", "--reduced", "--device", "cpu",
            "--batch", "3", "--n-requests", "5", "--prompt-len", "12", "--gen", "6",
            "--chunk-size", "4", "--block-size", "4"]
    one = serve.main(argv)
    argv2 = argv + ["--model-parallel", "2"]
    ap = serve.build_parser()
    args = ap.parse_args(argv2)
    serve.check_mode(ap, args)
    two = serve.run_sharded(args, argv2, timeout=SPAWN_TIMEOUT)   # what main runs, with a deadline
    assert two.backend == "gloo" and two.mesh == {"data": 1, "model": 2}
    want = {r: (c.tokens.tolist(), c.finished_step) for r, c in one.done.items()}
    for rank in two.ranks:
        assert {r: (c.tokens.tolist(), c.finished_step) for r, c in rank.done.items()} == want
    rep = two.ranks[0].report
    line = [ln for ln in capfd.readouterr().out.splitlines() if "sharded:" in ln]
    assert len(line) == 1 and "model_parallel=2, gloo" in line[0], line
    per_dev, total = (int(x.replace(",", "")) for x in re.search(
        r"KV per device ([\d,]+) of ([\d,]+) bytes", line[0]).groups())
    assert (per_dev, total) == (rep["per_device_bytes"], rep["bytes"])
    assert total / 2 < per_dev < total / 2 + 1024


def _every_arch_argv():
    """The command line's one-shot mode on every ``ARCH_ID`` and its
    dense-cache scheduler on the transformer family, reduced."""
    out = []
    for arch in TCFG.ARCH_IDS:
        base = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "4", "--kv-posit", "posit16"]
        out.append(base)
        if TCFG.get_config(arch).family == "transformer":
            out.append(base + ["--continuous", "--n-requests", "3", "--chunk-size", "4"])
    return out


def test_serve_refuses_uncovered_modes():
    """``serve --model-parallel 2`` runs the one-shot mode on every
    ``ARCH_ID`` and the dense-cache scheduler on the transformer family
    (each rank as ``main``'s ranks run, ``serve._serve_rank``, in one
    launch), every rank with the tokens of ``--model-parallel 1``; the
    modes the reference refuses outside the transformer family raise its
    ``ValueError`` before any rank starts."""
    argvs = _every_arch_argv()
    ranks = M.spawn(tp_lanes.serve_every_arch, ["cpu", "cpu"], (argvs,),
                    timeout=SPAWN_TIMEOUT, threads=1)
    for i, argv in enumerate(argvs):
        one = serve.main(argv)
        for rank in ranks:
            got = rank[i]
            if "--continuous" in argv:
                assert got == {r: c.tokens.tolist() for r, c in one.done.items()}, argv
            else:
                assert got == one.tolist(), argv
    base = ["--reduced", "--device", "cpu", "--model-parallel", "2", "--arch", "rwkv6-7b"]
    for extra in (["--continuous"], ["--continuous", "--paged"], ["--paged"]):
        with pytest.raises(ValueError, match="transformer family"):
            serve.main(base + extra)


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        M.spawn(tp_lanes.fails_on_rank_1, ["cpu", "cpu"], timeout=60, threads=1)


def test_backends():
    assert M.backend_for(["cpu", "cpu"]) == "gloo"
    assert M.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert M.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert M.default_devices(2, "cpu") == ["cpu", "cpu"]
    assert M.default_devices(2, "cuda") == ["cuda:0", "cuda:1"]
