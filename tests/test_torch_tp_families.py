"""hymba, rwkv6 and whisper served tensor-parallel, on gloo ranks on the
CPU, against the reference's single-device run.

The one-shot engine, these families' only one, under a rank mesh: the
port's ranks (``launch/mesh.spawn``, gloo; the rank code in
``tests/tp_linear.py``) are held to the reference's single-device JAX
``generate`` on the same weights (``weights.params_from_jax``; biases,
norms, ``w0``, ``u``, ``A_log``, ``dt_bias``, ``D`` and the mixing
vectors drawn from a seed, ``tp_linear.perturb``), reduced configs in
f32 (4 heads, 2 KV heads, 4 SSM heads: every group splits at mp 2) with
posit16 KV.  At mp 2 on the three families, and at mp 4 on hymba, whose
2 KV heads do not divide, so its attention and SSM heads run whole on
every rank while its MLP and vocabulary split: greedy tokens equal to
the reference's, prefill logits within 1e-4, ``generate_stepwise``
equal to ``generate`` bit for bit, every rank's tokens identical, and
``per_device_bytes`` the split share (hymba's ring, global KV and SSM
state, rwkv6's ``wkv``, whisper's self and cross K/V).  On the ranks:
the split norms (``layers.layer_norm``/``rms_norm`` over features split
over the ranks, ``collectives.TensorParallel.feature_sum``) within 1e-6
of the whole norm in output and in the input's gradient, and every
parameter of the three families through ``NamedSharding.shard`` and
``sharding.unshard`` bit for bit, hymba's segmented ``in_proj``
included.  In bf16 the sharded rwkv6 drifts from one device with depth,
and the drift is the rounding of the split's sums alone: one device that
rounds its row-parallel partial sums and sums its ``ln_x`` statistics as
two ranks do gives the ranks' logits bit for bit.  One spawn a mesh
size; the reference runs while the ranks do.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

import jax

import tp_linear as TL
from repro import configs as RCFG
from repro.models import get_family
from repro.runtime.engine import Engine as RefEngine
from repro_torch.launch import mesh as M

FAMILIES = ["hymba", "rwkv6", "whisper"]
MP4 = ["hymba"]
SPAWN_TIMEOUT = 300
LOGIT_TOL = 1e-4
NORM_TOL = 1e-6
# the cache leaves each family splits where its heads split
SPLIT = {"hymba": {"k_swa", "v_swa", "k_glb", "v_glb", "ssm"}, "rwkv6": {"wkv"},
         "whisper": {"k", "v", "ck", "cv"}}


@pytest.fixture(scope="module")
def runs():
    np_params, ref_params = {}, {}
    for lane in FAMILIES:
        rc = TL.lane_config(RCFG, lane)
        raw = get_family(rc).init_params(jax.random.PRNGKey(0), rc)
        np_params[TL.param_key(lane)] = TL.perturb(jax.tree.map(np.asarray, raw))
        ref_params[lane] = jax.tree.map(jax.numpy.asarray, np_params[TL.param_key(lane)])
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        mp2 = pool.submit(M.spawn, TL.rank_run, ["cpu"] * 2,
                          ({"oneshot": FAMILIES, "norms": True, "round_trip": True,
                            "bf16_drift": True}, np_params, 2),
                          timeout=SPAWN_TIMEOUT, threads=1)
        mp4 = pool.submit(M.spawn, TL.rank_run, ["cpu"] * 4, ({"oneshot": MP4}, np_params, 4),
                          timeout=SPAWN_TIMEOUT, threads=1)
        ref = {}
        for lane in FAMILIES:
            rc = TL.lane_config(RCFG, lane)
            prompts, kw = TL.inputs(rc, lane)
            res = RefEngine(rc, ref_params[lane], max_len=TL.MAX_LEN).generate(
                np.asarray(prompts), TL.GEN, **{k: jax.numpy.asarray(v) for k, v in kw.items()})
            ref[lane] = {"tokens": np.asarray(res.tokens).tolist(),
                         "logits": np.asarray(res.prefill_logits)}
        return {"ref": ref, 2: mp2.result(), 4: mp4.result()}


CASES = [(lane, 2) for lane in FAMILIES] + [(lane, 4) for lane in MP4]
IDS = [f"{lane}-mp{mp}" for lane, mp in CASES]


@pytest.mark.parametrize("lane,mp", CASES, ids=IDS)
def test_family_matches_reference(runs, lane, mp):
    want = runs["ref"][lane]
    for rank, got in enumerate(r[lane] for r in runs[mp]):
        assert got["tokens"] == want["tokens"], rank
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("lane,mp", CASES, ids=IDS)
def test_family_stepwise_equals_generate(runs, lane, mp):
    for got in (r[lane] for r in runs[mp]):
        assert got["stepwise"] == got["tokens"] == runs[mp][0][lane]["tokens"]


@pytest.mark.parametrize("lane,mp", CASES, ids=IDS)
def test_family_per_device_bytes(runs, lane, mp):
    """The split leaves and the rank-local heads: at mp 2 every group of
    the three; hymba at mp 4 keeps its attention and SSM heads (and so
    its caches) whole and splits its MLP."""
    cfg = TL.lane_config(RCFG, lane)
    heads_split = mp == 2
    for got in (r[lane] for r in runs[mp]):
        rep, leaf, shards = got["report"], got["leaf_bytes"], got["shards"]
        assert set(shards) == (SPLIT[lane] if heads_split else set())
        assert rep["per_device_bytes"] == sum(leaf.values())
        whole = sum(b * shards.get(k, 1) for k, b in leaf.items())
        assert rep["bytes"] == whole
        assert rep["per_device_bytes"] == whole - sum(leaf[k] for k in shards) * (mp - 1)
        h, g, ff, hs = got["local"]
        assert ff == cfg.d_ff // mp
        assert h == (cfg.n_heads // mp if heads_split else cfg.n_heads)
        if lane == "hymba":
            assert hs == (cfg.ssm_heads // mp if heads_split else cfg.ssm_heads)
            assert g == (cfg.n_kv_heads // mp if heads_split else cfg.n_kv_heads)


@pytest.mark.parametrize("norm", ["layer_norm", "rms_norm"])
def test_split_norms_equal_the_whole_norm(runs, norm):
    for got in (r["norms"][norm] for r in runs[2]):
        out, grad = got
        assert out <= NORM_TOL and grad <= NORM_TOL, got


def test_unshard_of_every_shard_is_the_whole_leaf(runs):
    for rank in runs[2]:
        trip = rank["round_trip"]
        assert all(trip[lane] == [] for lane in FAMILIES), trip
        assert "Segments" in trip["in_proj"]


def _dense_halves(p, x, cfg, tp=None):
    """One device's row-parallel ``dense`` as two ranks round it: each
    half of the rows' product rounded to ``x``'s dtype, summed in f32."""
    from repro_torch.models import layers as L

    w = L.maybe_dequant(p["w"], cfg).to(x.dtype)
    h = w.shape[0] // 2
    y = ((x[..., :h] @ w[:h]).to(torch.float32)
         + (x[..., h:] @ w[h:]).to(torch.float32)).to(x.dtype)
    return y + p["b"].to(y.dtype) if "b" in p else y


def _halves_layer_norm(split_norms, layer_norm):
    """``layers.layer_norm`` whose statistics, on the norms of
    ``split_norms`` (by identity), are summed as two ranks sum them: each
    half's f32 sum, then their sum."""
    def norm(p, x, eps=1e-5, tp=None):
        if id(p) not in split_norms:
            return layer_norm(p, x, eps, tp)
        dt, x = x.dtype, x.to(torch.float32)
        n, h = x.shape[-1], x.shape[-1] // 2

        def mean(t):
            return (t[..., :h].sum(-1, keepdim=True) + t[..., h:].sum(-1, keepdim=True)) / n
        mu = mean(x)
        y = (x - mu) * torch.rsqrt(mean((x - mu) ** 2) + eps)
        return (y * p["scale"] + p["bias"]).to(dt)
    return norm


def test_bf16_drift_is_the_split_sums_rounding(runs, monkeypatch):
    """In bf16 the sharded rwkv6's logits drift from one device's (a
    recurrence over 8 layers amplifies rounding), and the drift is the
    rounding of the split's sums alone: one device whose ``wo`` and
    ``cm_wv`` products are rounded as two ranks round their partial sums,
    and whose ``ln_x`` statistics are summed as two ranks sum them, gives
    the ranks' logits bit for bit."""
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models.registry import get_family
    from repro_torch.runtime.engine import Engine

    cfg = TL.drift_config(configs)
    params = get_family(cfg).init_params(cfg, seed=0, device="cpu")
    eng = Engine(cfg, params, max_len=TL.DRIFT["prompt"], device="cpu")
    prompts = TL.drift_prompts(cfg)
    plain = eng.prefill(prompts)[1].numpy()
    monkeypatch.setattr(L, "dense_row", _dense_halves)
    monkeypatch.setattr(L, "layer_norm", _halves_layer_norm(
        {id(lp["ln_x"]) for lp in params["layers"]}, L.layer_norm))
    emulated = eng.prefill(prompts)[1].numpy()
    for rank in runs[2]:
        assert np.array_equal(rank["bf16_drift"], emulated)
    drift = np.abs(plain - emulated).max(-1) / plain.std(-1)
    assert drift.max() > 1e-2          # a drift there is, and it is the rounding's
