"""The PVU ISA's posit-domain consumers in the port against the reference:
wire-format gradient reductions (``compress/gradient.py``), cache
maintenance on a paged posit16 arena (``compress/kvcache.py``), and the
model's posit linear layers (``models/layers.py``: ``dense`` honouring
``posit_exact_linear`` and posit-pattern weights, ``maybe_dequant`` at
``lm_head`` and MLA's ``wuk``/``wuv``).  The reference's Pallas kernels
run in interpret mode.  Patterns and the posit-exact linear's f32
outputs must be bit-exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import configs as RCFG
from repro.compress import gradient as RG
from repro.compress import kvcache as RK
from repro.models import layers as RL
from repro_torch import configs as TCFG
from repro_torch.compress import gradient as TG
from repro_torch.compress import kvcache as TK
from repro_torch.core.convert import posit_to_f32
from repro_torch.core.types import POSIT16, signed_view
from repro_torch.kernels import ops as TO
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small int64 ops per call: under the suite's parallel workers
    torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return signed_view(t).numpy().view(np.uint16)


def _tree(seed):
    rng = np.random.default_rng(seed)
    x = {"w": rng.standard_normal((3, 40)).astype(np.float32),
         "b": (rng.standard_normal((7,)) * 1e-3).astype(np.float32)}
    return {k: np.array(RG.f32_to_posit(jnp.asarray(v), POSIT16_R))
            for k, v in x.items()}


POSIT16_R = RG.pcfg_of("posit16")


def test_wire_format_reductions_match_reference():
    qa, qb = _tree(1), _tree(2)
    ta = {k: torch.from_numpy(v) for k, v in qa.items()}
    tb = {k: torch.from_numpy(v) for k, v in qb.items()}
    ja = {k: jnp.asarray(v) for k, v in qa.items()}
    jb = {k: jnp.asarray(v) for k, v in qb.items()}
    got = TG.combine_compressed(ta, tb, "posit16")
    want = RG.combine_compressed(ja, jb, "posit16")
    got_s = TG.scale_compressed(ta, 0.37, "posit16")
    want_s = RG.scale_compressed(ja, 0.37, "posit16")
    stack = {k: np.stack([qa[k], qb[k], _tree(3)[k]]) for k in qa}
    got_m = TG.mean_compressed({k: torch.from_numpy(v) for k, v in stack.items()},
                               "posit16")
    want_m = RG.mean_compressed({k: jnp.asarray(v) for k, v in stack.items()},
                                "posit16")
    for k in qa:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
        np.testing.assert_array_equal(_np(got_s[k]), np.asarray(want_s[k]))
        np.testing.assert_array_equal(_np(got_m[k]), np.asarray(want_m[k]))
    dec = TG.decompress(got, "posit16")
    np.testing.assert_array_equal(dec["w"].numpy(),
                                  np.asarray(RG.decompress(want, "posit16")["w"]))
    assert int(TG.scalar_pattern(0.37, POSIT16).to(torch.int64)) == \
        int(RG.scalar_pattern(0.37, POSIT16_R))


def _served_arena():
    """A paged posit16 cache after a reduced phi3 prefill of two rows
    (the second with a sentinel table tail)."""
    cfg = dataclasses.replace(
        TCFG.get_config("phi3-medium-14b").reduced(compute_dtype="float32"),
        kv_posit="posit16")
    params = T.init_params(cfg, seed=0, device="cpu")
    bs, max_len = 4, 24
    w = -(-max_len // bs)
    cache = T.init_paged_cache(cfg, 2, max_len, bs, 2 * w, device="cpu")
    tables = torch.arange(2 * w, dtype=torch.int32).reshape(2, w)
    tables[1, 3:] = 2 * w
    cache["block_tables"] = tables
    rng = np.random.default_rng(0)
    for nv in ([4, 4], [4, 3], [2, 0]):
        toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 4)).astype(np.int32))
        cache, _ = T.prefill_chunk(params, cache, toks, cfg,
                                   torch.tensor(nv, dtype=torch.int32),
                                   virtual_width=w)
    return cache


def _to_ref(cache):
    """The port's cache as the reference's tree (``max_len``, a Python
    int in the port, as a 0-d array)."""
    return {k: jnp.asarray(_np(v) if v.dtype == torch.uint16 else v.numpy())
            if isinstance(v, torch.Tensor) else jnp.asarray(v)
            for k, v in cache.items()}


def test_scale_and_merge_cache_match_reference_and_keep_metadata():
    cache = _served_arena()
    keys = TK.arena_leaves(cache)
    assert keys and all(cache[k].dtype == torch.uint16 for k in keys)
    ref = _to_ref(cache)
    scaled = TK.scale_cache(cache, 0.5, "posit16")
    want_s = RK.scale_cache(ref, 0.5, "posit16")
    merged = TK.merge_caches(cache, scaled, "posit16", weight_a=0.25)
    want_m = RK.merge_caches(ref, want_s, "posit16", weight_a=0.25)
    for k in keys:
        np.testing.assert_array_equal(_np(scaled[k]), np.asarray(want_s[k]))
        np.testing.assert_array_equal(_np(merged[k]), np.asarray(want_m[k]))
    for out in (scaled, merged):
        assert out["block_tables"] is cache["block_tables"]
        assert out["lens"] is cache["lens"]
        assert out["max_len"] == cache["max_len"]
    bad = dict(cache, lens=cache["lens"] + 1)
    with pytest.raises(ValueError, match="metadata"):
        TK.merge_caches(cache, bad, "posit16")
    with pytest.raises(ValueError, match="unknown unsigned cache leaf"):
        TK.scale_cache(dict(cache, mystery=cache["k"]), 0.5, "posit16")


def _cfgs(**kw):
    return (RCFG.get_config("phi3-medium-14b").reduced(**kw),
            TCFG.get_config("phi3-medium-14b").reduced(**kw))


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_dense_posit_exact_linear_matches_reference(bias):
    """``posit_exact_linear=True``: quantize, pgemm, vadd, dequantize --
    the reference's datapath, so the f32 outputs are equal bit for bit
    (4 tokens x 48 -> 40, posit16)."""
    rc, tc = _cfgs(posit_exact_linear=True, weight_posit="posit16")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 48)).astype(np.float32)
    p = {"w": (rng.standard_normal((48, 40)) * 48 ** -0.5).astype(np.float32)}
    if bias:
        p["b"] = rng.standard_normal((40,)).astype(np.float32)
    want = np.asarray(RL.dense({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), rc))
    got = TL.dense({k: torch.from_numpy(v) for k, v in p.items()},
                   torch.from_numpy(x), tc).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # the float path rounds per f32 op: it is not the posit-exact one
    flt = x @ p["w"] + (p["b"] if bias else 0)
    assert not np.array_equal(got, flt.astype(np.float32))


def test_posit_pattern_weights_decode_through_maybe_dequant():
    """Posit16 pattern weights: the float ``dense`` decodes them first
    (small-integer data, so the f32 sums are exact in any order), the
    posit-exact one uses the patterns as they are, and ``lm_head`` reads
    decode."""
    rc, tc = _cfgs(weight_posit="posit16")
    rng = np.random.default_rng(6)
    x = rng.integers(-3, 4, (4, 48)).astype(np.float32)
    wf = rng.integers(-3, 4, (48, 40)).astype(np.float32)
    wq = np.array(RG.f32_to_posit(jnp.asarray(wf), POSIT16_R))
    want = np.asarray(RL.dense({"w": jnp.asarray(wq)}, jnp.asarray(x), rc))
    got = TL.dense({"w": torch.from_numpy(wq)}, torch.from_numpy(x), tc).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x @ wf)

    rc_e, tc_e = _cfgs(weight_posit="posit16", posit_exact_linear=True)
    want = np.asarray(RL.dense({"w": jnp.asarray(wq)}, jnp.asarray(x), rc_e))
    got = TL.dense({"w": torch.from_numpy(wq)}, torch.from_numpy(x), tc_e).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))

    params = {"lm_head": {"w": torch.from_numpy(wq)}}
    np.testing.assert_array_equal(
        T._unembed_weight(params, dataclasses.replace(tc, tie_embeddings=False)
                          ).numpy(), posit_to_f32(torch.from_numpy(wq), POSIT16).numpy())


def test_mla_and_lm_head_posit_weights_equal_their_decoded_values():
    """Reduced minicpm3 with ``wuk``/``wuv`` and ``lm_head`` stored as
    posit16 patterns gives the same logits, bit for bit, as the same
    weights stored decoded in f32: the MLA absorb reads (prefill through
    ``dense``, decode through ``maybe_dequant``) and the unembedding
    decode the patterns."""
    cfg = dataclasses.replace(
        TCFG.get_config("minicpm3-4b").reduced(compute_dtype="float32"),
        weight_posit="posit16", tie_embeddings=False)
    params = T.init_params(cfg, seed=1, device="cpu")
    quant, dec = dict(params), dict(params)
    quant["layers"], dec["layers"] = [], []
    for lp in params["layers"]:
        qa, da = dict(lp["attn"]), dict(lp["attn"])
        for name in ("wuk", "wuv"):
            q = TL.pcfg("posit16")
            qa[name] = {"w": TO.quantize(lp["attn"][name]["w"], q)}
            da[name] = {"w": posit_to_f32(qa[name]["w"], q)}
        quant["layers"].append(dict(lp, attn=qa))
        dec["layers"].append(dict(lp, attn=da))
    quant["lm_head"] = {"w": TO.quantize(params["lm_head"]["w"], POSIT16)}
    dec["lm_head"] = {"w": posit_to_f32(quant["lm_head"]["w"], POSIT16)}

    logits = []
    for p in (quant, dec):
        cache = T.init_paged_cache(cfg, 1, 16, 4, 4, device="cpu")
        cache["block_tables"] = torch.arange(4, dtype=torch.int32)[None]
        toks = torch.tensor([[5, 9, 2, 7]], dtype=torch.int32)
        cache, lp = T.prefill_chunk(p, cache, toks, cfg,
                                    torch.tensor([4], dtype=torch.int32),
                                    virtual_width=4)
        ld, cache = T.decode_step(p, cache, torch.tensor([3], dtype=torch.int32),
                                  cfg)
        logits.append((lp, ld))
    for a, b in zip(*logits):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)
