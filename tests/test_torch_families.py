"""The port's hymba, rwkv6 and whisper families against the reference.

At reduced width in f32 with the reference's parameters carried over by
``weights.params_from_jax``: ``Engine.generate`` gives the reference
engine's greedy tokens at f32 and posit16 KV (rwkv6 has no KV cache),
prefill logits within 1e-4 (the tolerance of
``tests/test_torch_engine.py``) and the same tokens from
``generate_stepwise``; whisper's encoder frames are drawn from a numpy
seed and reach the logits.  The recurrences (rwkv6's ``wkv_scan`` and
``wkv_chunked``, hymba's ``ssd_step``) are held within 1e-5 of the
reference's on the inputs of ``tests/test_models_smoke.py``; hymba's ring
writes, past the wrap, to the reference's caches within 1e-4.  The
reference's guards hold in the port (capacity, ragged batches, paged
and continuous serving outside the transformer family), and so do the
cache surgery on hymba's SSM state and the parameter converter on these
families' layouts.  The reference's results are computed once a module
and shared.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as RCFG
from repro.compress import kvcache as ref_kvc
from repro.models import get_family as ref_family
from repro.models import hymba as ref_hymba
from repro.models import rwkv6 as ref_rwkv6
from repro.runtime.engine import Engine as RefEngine
from repro_torch import configs as TCFG
from repro_torch.compress import kvcache as kvc
from repro_torch.core.types import signed_view
from repro_torch.models import build, get_family
from repro_torch.models import hymba, rwkv6
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import Scheduler
from repro_torch.weights import cache_from_jax, params_from_jax

ARCHS = ["hymba-1.5b", "rwkv6-7b", "whisper-tiny"]
CASES = [("hymba-1.5b", None), ("hymba-1.5b", "posit16"), ("rwkv6-7b", None),
         ("whisper-tiny", None), ("whisper-tiny", "posit16")]
CASE_IDS = [f"{a}-{kv or 'f32'}" for a, kv in CASES]
# prompt length: a multiple of the reduced rwkv6's wkv_chunk (8)
B, S, GEN, MAX_LEN = 3, 16, 8, 28


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfgs(arch, kv=None, **kw):
    return (RCFG.get_config(arch).reduced(compute_dtype="float32", kv_posit=kv, **kw),
            TCFG.get_config(arch).reduced(compute_dtype="float32", kv_posit=kv, **kw))


_PARAMS = {}


def _params(arch):
    """Reference parameters and the port's copy."""
    if arch not in _PARAMS:
        rc, tc = _cfgs(arch)
        rp = ref_family(rc).init_params(jax.random.PRNGKey(0), rc)
        _PARAMS[arch] = (rp, params_from_jax(rp, tc, device="cpu"))
    return _PARAMS[arch]


def _inputs(cfg):
    """A (B, S) prompt batch and, on whisper, encoder frames, from seeds."""
    rng = np.random.default_rng(5)
    prompts = rng.integers(1, cfg.vocab, (B, S))
    kw = {}
    if cfg.family == "whisper":
        kw["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return prompts, kw


@pytest.fixture(scope="module")
def reference():
    """The reference engine's ``generate`` on every case, computed once."""
    out = {}
    for arch, kv in CASES:
        rc, _ = _cfgs(arch, kv)
        rp, _ = _params(arch)
        prompts, kw = _inputs(rc)
        eng = RefEngine(rc, rp, max_len=MAX_LEN)
        res = eng.generate(prompts, GEN, **{k: jnp.asarray(v) for k, v in kw.items()})
        out[(arch, kv)] = (np.asarray(res.tokens), np.asarray(res.prefill_logits),
                           eng.n_compiles)
    return out


def _np(t):
    """A port tensor as numpy, unsigned patterns included."""
    if t.dtype == torch.uint16:
        return signed_view(t).numpy().view(np.uint16)
    return t.numpy()


def _assert_close_leaf(got, want, key):
    """A content leaf within 1e-4 of the reference's; posit16 patterns
    within two posit steps (signed pattern order is value order), 98 % of
    them equal.  The two packages' f32 KV differ in the last ulp, which
    can move a pattern across a rounding boundary; hymba's prefill and
    every decode step read such a key again, so a second step can
    follow."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, key
    if want.dtype == np.uint16:
        assert got.dtype == torch.uint16, key
        d = np.abs(_np(got).view(np.int16).astype(np.int64)
                   - want.view(np.int16).astype(np.int64))
        assert d.max() <= 2 and (d == 0).mean() >= 0.98, (key, d.max(), (d == 0).mean())
    else:
        np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-4, err_msg=key)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_arch_ids_equal_the_reference():
    assert TCFG.ARCH_IDS == RCFG.ARCH_IDS
    for arch in ARCHS:
        assert TCFG.get_config(arch).__dict__ == RCFG.get_config(arch).__dict__


def test_registry_families_and_build():
    for arch in TCFG.ARCH_IDS:
        cfg = TCFG.get_config(arch)
        assert get_family(cfg).__name__.rsplit(".", 1)[1] == \
            ref_family(RCFG.get_config(arch)).__name__.rsplit(".", 1)[1]
    with pytest.raises(ValueError, match="unknown model family 'mamba'"):
        get_family(dataclasses.replace(TCFG.get_config("rwkv6-7b"), family="mamba"))
    _, tc = _cfgs("hymba-1.5b")
    m = build(tc, device="cpu")
    params = m.init_params(seed=3)
    cache, logits = m.prefill(params, torch.ones((2, 4), dtype=torch.int64), max_len=8)
    logits2, cache = m.decode_step(params, cache, torch.ones(2, dtype=torch.int64))
    assert logits.shape == logits2.shape == (2, tc.vocab) and cache["len"] == 5
    assert m.init_cache(2, 8)["k_glb"].shape == (1, 2, 8, tc.n_kv_heads, tc.head_dim)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    """The port's own random parameters have the reference's leaves,
    shapes and (under bf16 compute) the f32 leaves the converter keeps."""
    rc, _ = _cfgs(arch)
    tc = dataclasses.replace(TCFG.get_config(arch).reduced(), compute_dtype="bfloat16")
    want = params_from_jax(_params(arch)[0], tc, device="cpu", dtype=torch.bfloat16)
    got = get_family(tc).init_params(tc, seed=1, device="cpu")

    def leaves(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from leaves(v, path + (i,))
        else:
            yield path, t

    w, g = dict(leaves(want)), dict(leaves(got))
    assert set(w) == set(g)
    for path, t in w.items():
        assert g[path].shape == t.shape and g[path].dtype == t.dtype, path


# ---------------------------------------------------------------------------
# the engine against the reference engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kv", CASES, ids=CASE_IDS)
def test_generate_matches_reference(reference, arch, kv):
    """Greedy tokens equal, prefill logits within 1e-4, the dispatch count
    equal to the reference's compile count, and ``generate_stepwise``
    equal to ``generate``."""
    _, tc = _cfgs(arch, kv)
    _, tp = _params(arch)
    prompts, kw = _inputs(tc)
    want_tokens, want_logits, want_compiles = reference[(arch, kv)]
    eng = Engine(tc, tp, max_len=MAX_LEN, device="cpu")
    got = eng.generate(prompts, GEN, **kw)
    np.testing.assert_array_equal(got.tokens, want_tokens)
    np.testing.assert_allclose(got.prefill_logits, want_logits, rtol=1e-4, atol=1e-4)
    assert eng.n_compiles == want_compiles
    np.testing.assert_array_equal(eng.generate_stepwise(prompts, GEN, **kw).tokens,
                                  got.tokens)


def test_whisper_frames_reach_the_logits(reference):
    _, tc = _cfgs("whisper-tiny")
    _, tp = _params("whisper-tiny")
    prompts, kw = _inputs(tc)
    eng = Engine(tc, tp, max_len=MAX_LEN, device="cpu")
    zero = eng.prefill(prompts, frames=np.zeros_like(kw["frames"]))[1].numpy()
    assert np.abs(zero - reference[("whisper-tiny", None)][1]).max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_matches_reference(arch):
    """The cache after the prompt: metadata equal, content as
    ``_assert_close_leaf`` holds it."""
    for kv in (None, "posit16") if arch != "rwkv6-7b" else (None,):
        rc, tc = _cfgs(arch, kv)
        rp, tp = _params(arch)
        prompts, kw = _inputs(tc)
        ref_cache, _ = ref_family(rc).prefill(
            rp, jnp.asarray(prompts), rc, max_len=MAX_LEN,
            **{k: jnp.asarray(v) for k, v in kw.items()})
        cache, _ = get_family(tc).prefill(
            tp, torch.as_tensor(prompts), tc, max_len=MAX_LEN,
            **{k: torch.as_tensor(v) for k, v in kw.items()})
        assert set(cache) == set(ref_cache), arch
        for key, want in ref_cache.items():
            if key in ("len", "max_len"):
                assert int(cache[key]) == int(want), key
            else:
                _assert_close_leaf(cache[key], want, key)


# ---------------------------------------------------------------------------
# the recurrences, on the inputs of tests/test_models_smoke.py
# ---------------------------------------------------------------------------

def _wkv_inputs():
    rng = np.random.default_rng(3)
    b, s, h, n = 2, 32, 3, 8
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.2, 0.99, (b, s, h, n)).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    st = rng.standard_normal((b, h, n, n)).astype(np.float32)
    return r, k, v, w, u, st


@pytest.mark.parametrize("engine", ["scan", "chunked"])
def test_wkv_matches_reference(engine):
    args = _wkv_inputs()
    if engine == "scan":
        want = ref_rwkv6.wkv_scan(*map(jnp.asarray, args))
        got = rwkv6.wkv_scan(*map(torch.as_tensor, args))
    else:
        want = ref_rwkv6.wkv_chunked(*map(jnp.asarray, args), chunk=8)
        got = rwkv6.wkv_chunked(*map(torch.as_tensor, args), chunk=8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    with pytest.raises(AssertionError):
        rwkv6.wkv_chunked(*map(torch.as_tensor, args), chunk=7)


def test_ssd_step_matches_reference():
    rng = np.random.default_rng(4)
    b, s, h, p, n = 2, 16, 3, 4, 5
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    bi = rng.standard_normal((b, s, n)).astype(np.float32)
    ci = rng.standard_normal((b, s, n)).astype(np.float32)
    dt = rng.uniform(0.1, 1.0, (b, s, h)).astype(np.float32)
    a_log = rng.uniform(-1, 0.5, (h,)).astype(np.float32)
    h_ref = jnp.zeros((b, h, p, n), jnp.float32)
    h_port = torch.zeros((b, h, p, n))
    for t in range(s):
        y_ref, h_ref = ref_hymba.ssd_step(x[:, t], bi[:, t], ci[:, t], dt[:, t], a_log,
                                          h_ref)
        y, h_port = hymba.ssd_step(*(torch.as_tensor(a) for a in (
            x[:, t], bi[:, t], ci[:, t], dt[:, t], a_log)), h_port)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_port.numpy(), np.asarray(h_ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# hymba's ring (tests/test_engine.py::test_hymba_decode_no_clamp_overwrite)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", [None, "posit16"], ids=["f32", "posit16"])
def test_hymba_ring_no_clamp_overwrite(kv):
    """A 4-slot ring past its wrap: every step writes exactly ring slot
    ``pos % 4`` of every SWA layer, the global layer's prompt slots
    survive decode into headroom, the tokens are the reference's, and
    the decoded caches stay within 1e-4 of the reference's (posit16:
    ``_assert_close_leaf``)."""
    rc, tc = _cfgs("hymba-1.5b", kv, sliding_window=4)
    rp = ref_family(rc).init_params(jax.random.PRNGKey(3), rc)
    tp = params_from_jax(rp, tc, device="cpu")
    rng = np.random.default_rng(3)
    b, s, steps = 2, 6, 5
    tokens = rng.integers(1, tc.vocab, (b, s))
    ref_cache, ref_logits = ref_hymba.prefill(rp, jnp.asarray(tokens), rc, max_len=s + 8)
    cache, logits = hymba.prefill(tp, torch.as_tensor(tokens), tc, max_len=s + 8)
    w = cache["k_swa"].shape[2]
    assert w == tc.sliding_window
    gslot = _np(cache["k_glb"][0][:, :s]).copy()
    assert np.abs(gslot.astype(np.float64)).sum() > 0
    ref_step = jax.jit(lambda c, t: ref_hymba.decode_step(rp, c, t, rc))
    tok = torch.argmax(logits, -1)
    for _ in range(steps):
        pos = cache["len"]
        before = _np(cache["k_swa"]).copy()
        logits, cache = hymba.decode_step(tp, cache, tok, tc)
        ref_logits, ref_cache = ref_step(ref_cache, jnp.asarray(tok.numpy(), jnp.int32))
        after = _np(cache["k_swa"])
        for li in range(1, tc.n_layers):                 # layer 0 is global
            for t in range(w):
                same = (after[li][:, t] == before[li][:, t]).all()
                assert same != (t == pos % w), (pos, li, t)
        tok = torch.argmax(logits, -1)
        assert torch.equal(tok, torch.from_numpy(np.array(jnp.argmax(ref_logits, -1))))
    np.testing.assert_array_equal(_np(cache["k_glb"][0][:, :s]), gslot)
    assert np.abs(_np(cache["k_glb"][0][:, s:s + steps]).astype(np.float64)).sum() > 0
    assert cache["len"] == s + steps
    for key in ("k_swa", "v_swa", "k_glb", "v_glb", "ssm"):
        _assert_close_leaf(cache[key], ref_cache[key], key)
    np.testing.assert_array_equal(cache["lens"].numpy(), np.asarray(ref_cache["lens"]))


# ---------------------------------------------------------------------------
# the reference's guards
# ---------------------------------------------------------------------------

def test_whisper_decode_past_capacity_raises():
    _, tc = _cfgs("whisper-tiny")
    _, tp = _params("whisper-tiny")
    cap = 4
    cache = get_family(tc).init_cache(tc, 2, cap, device="cpu")
    tok = torch.tensor([3, 5])
    for _ in range(cap):
        _, cache = get_family(tc).decode_step(tp, cache, tok, tc)
    with pytest.raises(ValueError, match="capacity"):
        get_family(tc).decode_step(tp, cache, tok, tc)


def test_ragged_rejected_outside_transformer_family():
    _, tc = _cfgs("rwkv6-7b")
    eng = Engine(tc, _params("rwkv6-7b")[1], max_len=16, device="cpu")
    with pytest.raises(ValueError, match="ragged"):
        eng.generate([[1, 2], [3, 4, 5]], 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_and_continuous_need_the_transformer_family(arch):
    _, tc = _cfgs(arch)
    tp = _params(arch)[1]
    with pytest.raises(ValueError, match="paged KV caches need the transformer"):
        Engine(tc, tp, max_len=16, paged=True, device="cpu")
    eng = Engine(tc, tp, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="continuous batching needs per-row decode"):
        Scheduler(eng, n_slots=2)


@pytest.mark.parametrize("arch,kw", [("whisper-tiny", "frames"),
                                     ("internvl2-1b", "visual")])
def test_engine_routes_encoder_state(arch, kw):
    """frames/visual flow through prefill while decode runs off the cache
    (``tests/test_engine.py::test_engine_routes_encoder_state``)."""
    _, tc = _cfgs(arch)
    tp = get_family(tc).init_params(tc, seed=9, device="cpu")
    rng = np.random.default_rng(9)
    n = tc.encoder_seq if kw == "frames" else tc.n_visual_tokens
    aux = rng.standard_normal((2, n, tc.d_model)).astype(np.float32)
    eng = Engine(tc, tp, max_len=24, device="cpu")
    res = eng.generate(rng.integers(1, tc.vocab, (2, 8)), 8, **{kw: aux})
    assert res.tokens.shape == (2, 8)
    assert np.isfinite(res.prefill_logits).all()
    assert ("prefill", False, (kw,)) in {k[:3] for k in eng._dispatch_keys}


# ---------------------------------------------------------------------------
# the repairs: hymba's SSM state through the surgery; the converter
# ---------------------------------------------------------------------------

def test_kvcache_surgery_carries_hymba_ssm_state():
    """``reset_slots`` zeroes, and ``adopt_row`` grafts, the per-row SSM
    state as the reference's do, leaf for leaf."""
    rc, tc = _cfgs("hymba-1.5b", "posit16")
    rp, tp = _params("hymba-1.5b")
    rng = np.random.default_rng(11)
    pool_tokens = jnp.asarray(rng.integers(1, tc.vocab, (3, 10)))
    row_tokens = jnp.asarray(rng.integers(1, tc.vocab, (1, 7)))
    ref_pool, _ = ref_hymba.prefill(rp, pool_tokens, rc, max_len=24)
    ref_row, _ = ref_hymba.prefill(rp, row_tokens, rc, max_len=24)

    def port(c):
        return cache_from_jax(jax.tree.map(np.asarray, c), device="cpu")

    rows = np.array([False, True, False])
    want = ref_kvc.adopt_row(ref_kvc.reset_slots(ref_pool, jnp.asarray(rows)), ref_row, 1)
    got = kvc.adopt_row(kvc.reset_slots(port(ref_pool), torch.as_tensor(rows)),
                        port(ref_row), 1)
    reset_only = kvc.reset_slots(port(ref_pool), torch.as_tensor(rows))
    assert float(reset_only["ssm"][:, 1].abs().sum()) == 0.0
    assert float(reset_only["ssm"][:, 0].abs().sum()) > 0.0
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        if key in ("len", "max_len"):
            assert int(got[key]) == int(w), key
        else:
            np.testing.assert_array_equal(_np(got[key]), w, err_msg=key)
    np.testing.assert_array_equal(got["ssm"][:, 1].numpy(), np.asarray(ref_row["ssm"])[:, 0])


def test_params_from_jax_keeps_f32_leaves_and_unstacks_every_layer_tree():
    """Under bf16 storage the leaves the reference reads in f32 stay f32
    (norm scales and biases, rwkv6's ``w0`` and ``u``, hymba's ``A_log``,
    ``dt_bias`` and ``D``); whisper's two layer stacks become lists; the
    other leaves, dense biases included, take the dtype."""
    f32 = {"scale", "bias", "w0", "u", "A_log", "dt_bias", "D"}
    for arch in ARCHS:
        rp, _ = _params(arch)
        _, tc = _cfgs(arch)
        got = params_from_jax(rp, tc, device="cpu", dtype=torch.bfloat16)
        seen = set()

        def walk(t, key=None):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, k)
            elif isinstance(t, list):
                for v in t:
                    walk(v, key)
            else:
                seen.add(key)
                assert t.dtype == (torch.float32 if key in f32 else torch.bfloat16), \
                    (arch, key)

        walk(got)
        stacks = [k for k in ("layers", "enc_layers", "dec_layers") if k in rp]
        for k in stacks:
            n = (tc.encoder_layers or tc.n_layers) if k == "enc_layers" else tc.n_layers
            assert isinstance(got[k], list) and len(got[k]) == n, (arch, k)
        assert seen & f32, arch
    assert {"enc_layers", "dec_layers"} <= set(_params("whisper-tiny")[0])
    got = params_from_jax(_params("whisper-tiny")[0], _cfgs("whisper-tiny")[1],
                          device="cpu", dtype=torch.bfloat16)
    assert got["pos_embed"].shape == _params("whisper-tiny")[0]["pos_embed"].shape
    assert got["dec_layers"][0]["self"]["wq"]["b"].dtype == torch.bfloat16
