"""The port's paged transformer lanes (dense GQA, sliding window, MLA)
against ``repro.models.transformer``.

Weights come from the reference's ``init_params`` through
``weights.params_from_jax``; caches through ``weights.cache_from_jax``.
Tolerances: logits within atol = rtol = 1e-4 (the two packages run the
same f32 math through different BLAS and reduction orders).  Arena
contents: f32 KV within atol = rtol = 1e-5.  Posit16 KV is bit-equal
wherever the f32 K/V inputs are equal: ``_maybe_quant_kv`` is bit-exact
on identical inputs; in layer 0 of the arenas a pattern may differ by
one step at most (an f32 last-ulp difference on a rounding boundary),
and deeper layers, whose inputs were read back through the codec, agree
within rtol 1e-3 / atol 1e-4 once decoded (posit16 keeps 12 fraction
bits near 1, a relative step of 2.4e-4).  The port's own chunked prefill
must equal its whole-prompt prefill.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as RCFG
from repro.models import transformer as RT
from repro_torch import configs as TCFG
from repro_torch.core.convert import posit_to_f32
from repro_torch.core.types import POSIT16
from repro_torch.models import transformer as T
from repro_torch.weights import cache_from_jax, params_from_jax

ATOL = RTOL = 1e-4
BS, MAX_LEN = 4, 24


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfgs(lane, kv):
    arch = "minicpm3-4b" if lane == "mla" else "phi3-medium-14b"
    rc = RCFG.get_config(arch).reduced(compute_dtype="float32", kv_posit=kv)
    tc = TCFG.get_config(arch).reduced(compute_dtype="float32", kv_posit=kv)
    if lane == "window":
        rc = dataclasses.replace(rc, sliding_window=8, attn_chunk_kv=8)
        tc = dataclasses.replace(tc, sliding_window=8, attn_chunk_kv=8)
    return rc, tc


_PARAMS = {}


def _params(rc, tc):
    key = (rc.name, rc.sliding_window, rc.attn_chunk_kv)
    if key not in _PARAMS:
        rp = RT.init_params(jax.random.PRNGKey(0), rc)
        _PARAMS[key] = (rp, params_from_jax(jax.tree.map(np.asarray, rp), tc,
                                            device="cpu"))
    return _PARAMS[key]


def _ref_cache(rc, b):
    w = RT.paged_table_width(rc, BS, MAX_LEN)
    nb = b * w
    cache = RT.init_paged_cache(rc, b, MAX_LEN, BS, nb)
    tables = np.arange(nb, dtype=np.int32).reshape(b, w)[:, ::-1].copy()
    tables[-1, w // 2:] = nb                 # a short row with a sentinel tail
    return dict(cache, block_tables=jnp.asarray(tables))


def _to_port(cache):
    return cache_from_jax(jax.tree.map(np.asarray, cache), device="cpu")


def _check_arena(got, ref, kv):
    if kv is None:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=1e-5, rtol=1e-5)
        return
    diff = got.numpy().astype(np.int64) - np.asarray(ref).astype(np.int64)
    assert (np.abs(diff[0]) <= 1).all()
    assert (diff == 0).mean() > 0.99
    np.testing.assert_allclose(
        posit_to_f32(got, POSIT16).numpy(),
        posit_to_f32(torch.from_numpy(np.array(ref)), POSIT16).numpy(),
        rtol=1e-3, atol=1e-4)


def _chunks(rng, vocab, b, lens_seq):
    return [(rng.integers(1, vocab, (b, 4)).astype(np.int32),
             np.asarray(nv, np.int32)) for nv in lens_seq]


@pytest.mark.parametrize("kv", [None, "posit16"], ids=["f32", "posit16"])
@pytest.mark.parametrize("lane", ["dense", "window", "mla"])
def test_prefill_chunk_and_decode_step_match_reference(lane, kv):
    rc, tc = _cfgs(lane, kv)
    rp, tp = _params(rc, tc)
    b = 3
    rcache = _ref_cache(rc, b)
    tcache = _to_port(rcache)
    vw = -(-MAX_LEN // BS)
    rng = np.random.default_rng(7)
    # ragged prompts: 11, 8 and 4 tokens, the last row idle in chunk 3;
    # the window lane's 11-token row wraps its 12-slot ring on decode
    for toks, nv in _chunks(rng, rc.vocab, b, [[4, 4, 4], [4, 4, 0], [3, 0, 0]]):
        rcache, rl = RT.prefill_chunk(rp, rcache, jnp.asarray(toks), rc,
                                      jnp.asarray(nv), virtual_width=vw)
        tcache, tl = T.prefill_chunk(tp, tcache, torch.from_numpy(toks), tc,
                                     torch.from_numpy(nv), virtual_width=vw)
        live = nv > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(rl)[live],
                                   atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(tcache["lens"].numpy(), [11, 8, 4])
    for key in T.arena_keys(tc):
        _check_arena(tcache[key], rcache[key], kv)

    active = np.array([True, True, False])
    for step in range(3):
        tok = rng.integers(1, rc.vocab, (b,)).astype(np.int32)
        rl, rcache = RT.decode_step(rp, rcache, jnp.asarray(tok), rc,
                                    active=jnp.asarray(active))
        tl, tcache = T.decode_step(tp, tcache, torch.from_numpy(tok), tc,
                                   active=torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy()[active], np.asarray(rl)[active],
                                   atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(tcache["lens"].numpy(), [14, 11, 4])
    for key in T.arena_keys(tc):
        _check_arena(tcache[key], rcache[key], kv)


@pytest.mark.parametrize("kv", ["posit16", "posit8"])
def test_maybe_quant_kv_bit_exact(kv):
    rc, tc = _cfgs("dense", kv)
    x = np.random.default_rng(3).normal(size=(3, 4, 2, 16)).astype(np.float32)
    ref = np.asarray(RT._maybe_quant_kv(jnp.asarray(x), rc))
    got = T._maybe_quant_kv(torch.from_numpy(x), tc).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("lane", ["dense", "window", "mla"])
def test_chunked_prefill_equals_whole_prompt(lane):
    """At f32 KV, prefilling a 12-token prompt in 4-token chunks gives the
    same last-position logits and arena contents as one 12-token chunk
    (fixed ``attn_chunk_kv`` KV grouping)."""
    _, tc = _cfgs(lane, None)
    tp = T.init_params(tc, seed=1, device="cpu")
    vw = -(-MAX_LEN // BS)
    prompt = torch.from_numpy(
        np.random.default_rng(8).integers(1, tc.vocab, (1, 12)))
    outs = []
    for c in (12, 4):
        cache = T.init_paged_cache(tc, 1, MAX_LEN, BS,
                                   T.paged_table_width(tc, BS, MAX_LEN),
                                   device="cpu")
        w = cache["block_tables"].shape[1]
        cache["block_tables"] = torch.arange(w, dtype=torch.int32)[None]
        for i in range(0, 12, c):
            cache, logits = T.prefill_chunk(
                tp, cache, prompt[:, i:i + c], tc, torch.tensor([c]),
                virtual_width=vw)
        outs.append((logits, cache))
    (l_whole, c_whole), (l_chunk, c_chunk) = outs
    torch.testing.assert_close(l_chunk, l_whole, atol=0, rtol=0)
    for key in T.arena_keys(tc):
        torch.testing.assert_close(c_chunk[key], c_whole[key], atol=0, rtol=0)


def test_params_from_jax_carries_the_mla_tree():
    """The reference's MLA parameter tree converts leaf for leaf: every
    weight takes the requested dtype, the ``q_norm``/``kv_norm`` (and
    block) norm scales stay f32, and the port's own ``init_params``
    builds the same tree."""
    rc, tc = _cfgs("mla", None)
    rp = jax.tree.map(np.asarray, RT.init_params(jax.random.PRNGKey(0), rc))
    tp = params_from_jax(rp, tc, device="cpu", dtype=torch.bfloat16)
    own = T.init_params(tc, seed=0, device="cpu")
    assert len(tp["layers"]) == len(own["layers"]) == tc.n_layers
    got, mine = tp["layers"][1]["attn"], own["layers"][1]["attn"]
    assert got.keys() == mine.keys() == {
        "wdq", "q_norm", "wuq", "wdkv", "kv_norm", "wuk", "wuv", "wo"}
    for name, leaf in got.items():
        key = "scale" if "norm" in name else "w"
        ref = np.array(rp["layers"]["attn"][name][key][1])
        want = torch.float32 if key == "scale" else torch.bfloat16
        assert leaf[key].dtype == want
        assert leaf[key].shape == mine[name][key].shape == ref.shape
        np.testing.assert_array_equal(
            leaf[key].float().numpy(),
            torch.from_numpy(ref).to(want).float().numpy())
