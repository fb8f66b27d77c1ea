"""The port's one-shot engine, linear caches and cache surgery against the
reference.

Mirrors ``tests/test_engine.py``, the linear-cache parts of
``tests/test_paged.py`` and the surgery ops of ``tests/test_scheduler.py``
at reduced width.  The reference's parameters are carried over with
``weights.params_from_jax``.  Greedy tokens must be equal on the dense,
sliding-window and MLA lanes at f32, posit16 and posit8 KV, and prefill
logits within 1e-4 (the tolerance of ``test_torch_model.py``: the two
packages sum in other orders).  Inside the port, ``generate`` equals
``generate_stepwise`` and the paged engine the linear one, bit for bit.
The linear decode write (``_write_kv`` on a leaf seen as an arena of B
blocks of T slots) and the cache surgery (``reset_slots``, ``compact``,
``adopt_row``, ``paged_adopt_row``, ``quantize_cache``,
``dequantize_cache``) are held to the reference bit for bit on the same
input caches.
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
from repro.models import transformer as RT
from repro.runtime.engine import Engine as RefEngine
from repro_torch import configs as TCFG
from repro_torch.compress import kvcache as kvc
from repro_torch.core.types import signed_view
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.runtime.engine import Engine
from repro_torch.weights import cache_from_jax, params_from_jax

LANES = ["dense", "window", "mla"]
KVS = [None, "posit16", "posit8"]
KV_IDS = ["f32", "posit16", "posit8"]


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
    """Reference parameters and the port's copy (the KV codec does not
    change the weights)."""
    if lane not in _PARAMS:
        rc, tc = _cfgs(lane)
        rp = get_family(rc).init_params(jax.random.PRNGKey(0), rc)
        _PARAMS[lane] = (rp, params_from_jax(jax.tree.map(np.asarray, rp), tc,
                                             device="cpu"))
    return _PARAMS[lane]


def _np(t):
    """A port tensor as numpy, unsigned patterns included."""
    if t.dtype == torch.uint16:
        return signed_view(t).numpy().view(np.uint16)
    return t.numpy()


def _assert_same_cache(port, ref):
    """Every leaf equal bit for bit (scalars as ints)."""
    assert set(port) == set(ref)
    for key, want in ref.items():
        want = np.asarray(want)
        if key in ("len", "max_len"):
            assert int(port[key]) == int(want), key
        else:
            got = _np(port[key])
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, n).tolist() for n in lens]


# ---------------------------------------------------------------------------
# generate: tokens and prefill logits against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", KVS, ids=KV_IDS)
@pytest.mark.parametrize("lane", LANES)
def test_generate_matches_reference(lane, kv):
    """A ragged batch (the window lane's 11-token prompt ring-packs into
    its 8-slot ring) for 10 tokens: the linear engine's tokens and prefill
    logits equal the reference's, ``generate_stepwise`` and the paged
    engine (scan and stepwise) give the same tokens bit for bit, and the
    dispatch count equals the reference's compile count."""
    rc, tc = _cfgs(lane, kv)
    rp, tp = _params(lane)
    prompts = _prompts(tc, (5, 11, 3), seed=1)
    ref_eng = RefEngine(rc, rp, max_len=24)
    ref = ref_eng.generate(prompts, 10)

    eng = Engine(tc, tp, max_len=24, device="cpu")
    got = eng.generate(prompts, 10)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.prompt_lens, ref.prompt_lens)
    np.testing.assert_allclose(got.prefill_logits, ref.prefill_logits,
                               rtol=1e-4, atol=1e-4)
    assert got.tokens.dtype == np.int32 and got.tokens.shape == (3, 10)
    assert eng.n_compiles == ref_eng.n_compiles
    np.testing.assert_array_equal(eng.generate_stepwise(prompts, 10).tokens,
                                  got.tokens)

    pag = Engine(tc, tp, max_len=24, paged=True, block_size=4, device="cpu")
    np.testing.assert_array_equal(pag.generate(prompts, 10).tokens, ref.tokens)
    np.testing.assert_array_equal(pag.generate_stepwise(prompts, 10).tokens,
                                  ref.tokens)
    assert 0 < pag.pool.peak_in_use <= pag.pool.n_blocks


def _assert_close_cache(port, ref, name):
    """Metadata equal; content leaves decoded and within a posit16 step
    of the reference's (the two packages' f32 KV differ in the last ulp,
    which can move a pattern across a rounding boundary), with the same
    zero slots (padding and unwritten blocks)."""
    ref = jax.tree.map(np.asarray, ref)
    for key, want in ref.items():
        if key in ("len", "max_len"):
            assert int(port[key]) == int(want), key
        elif key in kvc.CONTENT_LEAVES:
            got = kvc.dequantize_cache({key: port[key]}, name)[key].numpy()
            want = np.asarray(RKV.dequantize_cache({key: want}, name)[key])
            np.testing.assert_array_equal(got == 0, want == 0, err_msg=key)
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(_np(port[key]), want, err_msg=key)


@pytest.mark.parametrize("lane", LANES)
def test_prefill_cache_matches_reference(lane):
    """The whole-prompt prefill's posit16 linear cache (padded, or ring
    packed on the window lane) against the reference's on a ragged
    batch: the same layout, values within a posit16 step.  (The paged
    prefill's packing is held bit for bit in
    ``test_paged_pack_matches_reference``.)"""
    rc, tc = _cfgs(lane, "posit16")
    rp, tp = _params(lane)
    prompts = _prompts(tc, (6, 10), seed=2)
    want, want_logits, _ = RefEngine(rc, rp, max_len=20).prefill(prompts)
    got, got_logits, _ = Engine(tc, tp, max_len=20, device="cpu").prefill(prompts)
    _assert_close_cache(got, want, "posit16")
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# decode_chunk, capacity, the clamp regression
# ---------------------------------------------------------------------------

def test_decode_chunk_concatenation_matches_generate():
    """Two 4-step quanta seeded from the prefill token emit exactly what
    ``generate``'s 9 tokens are."""
    _, tc = _cfgs("dense", "posit16")
    _, tp = _params("dense")
    prompts = np.random.default_rng(11).integers(1, tc.vocab, (2, 6))
    ref = Engine(tc, tp, max_len=24, device="cpu").generate(prompts, 9).tokens
    eng = Engine(tc, tp, max_len=24, device="cpu")
    cache, logits, _ = eng.prefill(prompts)
    tok0 = torch.argmax(logits, -1)
    cache, c1 = eng.decode_chunk(cache, tok0.numpy(), 4)
    cache, c2 = eng.decode_chunk(cache, c1[:, -1].numpy(), 4)
    got = torch.cat([tok0[:, None], c1, c2], dim=1).numpy()
    np.testing.assert_array_equal(got, ref)


def test_decode_chunk_active_mask_freezes_inactive_lens():
    _, tc = _cfgs("dense")
    _, tp = _params("dense")
    prompts = np.random.default_rng(12).integers(1, tc.vocab, (2, 5))
    eng = Engine(tc, tp, max_len=24, device="cpu")
    cache, logits, _ = eng.prefill(prompts)
    cache, _ = eng.decode_chunk(cache, torch.argmax(logits, -1).numpy(), 3,
                                active=np.array([True, False]))
    assert cache["lens"].tolist() == [8, 5]
    assert cache["len"] == 8             # the shared frontier still moves


def test_decode_chunk_and_generate_refuse_to_run_past_max_len():
    _, tc = _cfgs("dense")
    _, tp = _params("dense")
    rng = np.random.default_rng(13)
    eng = Engine(tc, tp, max_len=12, device="cpu")
    cache, logits, _ = eng.prefill(rng.integers(1, tc.vocab, (1, 6)))
    tok0 = torch.argmax(logits, -1).numpy()
    cache, _ = eng.decode_chunk(cache, tok0, 6)         # 6 + 6 = 12 fits
    with pytest.raises(ValueError, match="max_len"):
        eng.decode_chunk(cache, tok0, 1)                 # 13 > 12
    prompts = rng.integers(1, tc.vocab, (1, 8))
    eng.generate(prompts, 5)                             # 8 + 5 - 1 = 12 fits
    for fn in (eng.generate, eng.generate_stepwise):
        with pytest.raises(ValueError, match="max_len"):
            fn(prompts, 6)


@pytest.mark.parametrize("lane", ["dense", "mla"])
def test_decode_lands_in_headroom_without_clamping(lane):
    """Prefill 8 tokens into a 16-slot cache, decode 3: the last prompt
    slot is untouched, the steps land in headroom, and the logits follow
    the reference's decode steps."""
    rc, tc = _cfgs(lane)
    rp, tp = _params(lane)
    tokens = np.random.default_rng(0).integers(1, tc.vocab, (2, 8))
    ref_cache, ref_logits = RT.prefill(rp, jnp.asarray(tokens, jnp.int32), rc,
                                       max_len=16)
    cache, logits = T.prefill(tp, torch.as_tensor(tokens), tc, max_len=16)
    key = T.arena_keys(tc)[0]
    slot = cache[key][:, :, 7].clone()
    assert slot.abs().sum() > 0
    tok = torch.argmax(logits, -1)
    for _ in range(3):
        ref_logits, ref_cache = RT.decode_step(
            rp, ref_cache, jnp.asarray(tok.numpy(), jnp.int32), rc)
        logits, cache = T.decode_step(tp, cache, tok, tc)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   rtol=1e-4, atol=1e-4)
        tok = torch.argmax(logits, -1)
    assert torch.equal(cache[key][:, :, 7], slot)
    assert cache[key][:, :, 8:11].abs().sum() > 0
    assert cache["len"] == 11


@pytest.mark.parametrize("lane", LANES + ["paged"])
def test_decode_past_capacity_raises(lane):
    """A 4-slot cache takes 4 steps; the fifth raises before it runs (the
    window lane with a full-length cache is linear, not a ring)."""
    _, tc = _cfgs("dense" if lane == "paged" else lane)
    _, tp = _params("dense" if lane == "paged" else lane)
    if lane == "paged":
        cache = T.init_paged_cache(tc, 2, 4, 4, 2, device="cpu")
        cache["block_tables"] = torch.tensor([[0], [1]], dtype=torch.int32)
    else:
        cache = T.init_cache(tc, 2, 4, window_ring=False, device="cpu")
    tok = torch.tensor([3, 5])
    for _ in range(4):
        _, cache = T.decode_step(tp, cache, tok, tc)
    with pytest.raises(ValueError, match="capacity"):
        T.decode_step(tp, cache, tok, tc)


def test_sliding_window_ring_matches_full_length_cache():
    """The 8-slot ring (writes at ``pos % 8``, rotated masks, a 12-token
    prompt ring-packed) against a full-length cache over 20 steps, more
    than two wraparounds."""
    _, tc = _cfgs("window")
    _, tp = _params("window")
    tokens = torch.as_tensor(np.random.default_rng(4).integers(1, tc.vocab, (2, 12)))

    def run(window_ring):
        cache, logits = T.prefill(tp, tokens, tc, max_len=40,
                                  window_ring=window_ring)
        outs = [logits]
        tok = torch.argmax(logits, -1)
        for _ in range(20):
            logits, cache = T.decode_step(tp, cache, tok, tc)
            outs.append(logits)
            tok = torch.argmax(logits, -1)
        return outs, cache

    ring, ring_cache = run(True)
    full, full_cache = run(False)
    assert ring_cache["k"].shape[2] == 8 and full_cache["k"].shape[2] == 40
    for i, (a, b) in enumerate(zip(ring, full)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=f"step {i}")


def test_ragged_batch_matches_singleton_generations():
    _, tc = _cfgs("dense", "posit16")
    _, tp = _params("dense")
    p1, p2 = _prompts(tc, (5, 9), seed=6)
    batched = Engine(tc, tp, max_len=32, device="cpu").generate([p1, p2], 8)
    assert batched.prompt_lens.tolist() == [5, 9]
    for row, p in enumerate((p1, p2)):
        solo = Engine(tc, tp, max_len=32, device="cpu").generate([p], 8)
        np.testing.assert_allclose(batched.prefill_logits[row],
                                   solo.prefill_logits[0], rtol=5e-4, atol=5e-4)
        np.testing.assert_array_equal(batched.tokens[row], solo.tokens[0])


def test_engine_mode_checks_match_reference():
    rc, tc = _cfgs("dense")
    rp, tp = _params("dense")
    with pytest.raises(ValueError, match="paged=True"):
        Engine(tc, tp, max_len=16, decode_kernel="fused", device="cpu")
    eng = Engine(tc, tp, max_len=16, device="cpu")
    assert not eng.paged
    with pytest.raises(ValueError, match="paged=True"):
        eng.prefill([[1, 2, 3]], paged=True)
    with pytest.raises(ValueError, match="paged=True"):
        eng.mixed_step(None, np.zeros((1, 4)), [0], [0], 4)
    # a config with no visual tokens ignores ``visual``, as the reference does
    plain = eng.generate([[1, 2, 3]], 2).tokens
    np.testing.assert_array_equal(
        eng.generate([[1, 2, 3]], 2, visual=torch.ones((1, 8, 64))).tokens, plain)
    np.testing.assert_array_equal(
        RefEngine(rc, rp, max_len=16).generate(
            [[1, 2, 3]], 2, visual=jnp.ones((1, 8, 64))).tokens, plain)


# ---------------------------------------------------------------------------
# the linear decode write, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", KVS, ids=KV_IDS)
@pytest.mark.parametrize("pos,ring", [(3, False), (11, True), (8, False)],
                         ids=["linear", "ring-wrap", "past-capacity"])
def test_linear_decode_write_matches_reference(kv, pos, ring):
    """One layer's leaf (B, T, G, D) written at the frontier through the
    port's one destination form, against the reference's
    ``_maybe_quant_kv`` + ``guarded_cache_update`` (a write at
    ``pos >= T`` on a linear leaf is dropped, the leaf unchanged)."""
    rc, tc = _cfgs("dense", kv)
    rng = np.random.default_rng(7)
    b, t, g, d = 3, 8, 2, 16
    old = rng.normal(size=(b, t, g, d)).astype(np.float32)
    new = rng.normal(size=(b, 1, g, d)).astype(np.float32)
    ref_leaf = RT._maybe_quant_kv(jnp.asarray(old), rc)
    want = RL.guarded_cache_update(ref_leaf, RT._maybe_quant_kv(jnp.asarray(new), rc),
                                   pos % t if ring else pos, 1)
    leaf = cache_from_jax({"k": np.asarray(ref_leaf)}, device="cpu")["k"]
    slots = L.linear_write_slots(b, t, pos, ring=ring, device="cpu")
    T._write_kv([(leaf, torch.from_numpy(new)[:, 0])], slots, tc)
    np.testing.assert_array_equal(_np(leaf), np.asarray(want))
    if pos >= t and not ring:
        assert (slots == -1).all()
        np.testing.assert_array_equal(_np(leaf), np.asarray(ref_leaf))


def test_guarded_cache_update_drops_past_capacity():
    arr = torch.zeros((2, 4, 3))
    upd = torch.ones((2, 1, 3))
    L.guarded_cache_update(arr, upd, 4, 1)
    assert arr.abs().sum() == 0
    L.guarded_cache_update(arr, upd, 3, 1)
    assert torch.equal(arr[:, 3], upd[:, 0]) and arr[:, :3].abs().sum() == 0


# ---------------------------------------------------------------------------
# cache surgery, bit for bit
# ---------------------------------------------------------------------------

def _ref_linear_cache(lane, kv, prompts, max_len):
    rc, _ = _cfgs(lane, kv)
    rp, _ = _params(lane)
    cache, _, _ = RefEngine(rc, rp, max_len=max_len).prefill(prompts)
    return cache


@pytest.mark.parametrize("lane", LANES)
def test_reset_compact_adopt_row_match_reference(lane):
    """The dense-cache scheduler's three surgery ops on a posit16 pool
    (a window ring on that lane): each output equal to the reference's."""
    _, tc = _cfgs(lane, "posit16")
    pool_ref = _ref_linear_cache(lane, "posit16", _prompts(tc, (6, 9), 8), 20)
    row_ref = _ref_linear_cache(lane, "posit16", _prompts(tc, (5,), 9), 20)
    pool = cache_from_jax(jax.tree.map(np.asarray, pool_ref), device="cpu")
    row = cache_from_jax(jax.tree.map(np.asarray, row_ref), device="cpu")

    want = RKV.reset_slots(pool_ref, jnp.asarray([True, False]))
    got = kvc.reset_slots(dict(pool, **{k: v.clone() for k, v in pool.items()
                                        if isinstance(v, torch.Tensor)}),
                          np.array([True, False]))
    _assert_same_cache(got, jax.tree.map(np.asarray, want))

    for target in (12, 4, None):
        want = RKV.compact(pool_ref, None if target is None else jnp.int32(target))
        _assert_same_cache(kvc.compact(pool, target), jax.tree.map(np.asarray, want))
    with pytest.raises(ValueError, match="max_len"):
        kvc.compact(pool, 21)

    grown_ref = RKV.compact(pool_ref, jnp.int32(12))
    want = RKV.adopt_row(grown_ref, row_ref, jnp.int32(0))
    got = kvc.adopt_row(kvc.compact(pool, 12), row, 0)
    _assert_same_cache(got, jax.tree.map(np.asarray, want))
    small = kvc.compact(pool, 4)
    with pytest.raises(ValueError, match="frontier"):
        kvc.adopt_row(small, row, 0)


def test_roll_and_pad_cache_time_match_reference():
    kv = torch.arange(2 * 3 * 5, dtype=torch.int64).reshape(2, 3, 5).to(torch.uint16)
    for shift in (2, -3, 0):
        np.testing.assert_array_equal(_np(L.roll_cache_time(kv, shift)),
                                      np.asarray(RL.roll_cache_time(_np(kv), shift)))
    for t in (5, 9):
        np.testing.assert_array_equal(_np(L.pad_cache_time(kv, t)),
                                      np.asarray(RL.pad_cache_time(_np(kv), t)))


@pytest.mark.parametrize("window,src", [(0, "shift"), (0, "none"), (8, "shift"),
                                        (8, "ring")])
def test_paged_pack_matches_reference(window, src):
    """The whole-block pack of prompt patterns into arena blocks (a
    left-padded batch's ``src_shift``, a ring-layout source, sentinel
    entries dropped), bit for bit on the same posit16 patterns."""
    rng = np.random.default_rng(14)
    n_layers, b, s, g, d, bs = 2, 2, 12, 2, 4, 4
    w = L.paged_window_blocks(window, bs) if window else 4
    nb = b * w + 1
    kvs = rng.integers(0, 1 << 16, (n_layers, b, s, g, d)).astype(np.uint16)
    arena = rng.integers(0, 1 << 16, (n_layers, nb, bs, g, d)).astype(np.uint16)
    tables = rng.permutation(nb)[:b * w].reshape(b, w).astype(np.int32)
    tables[0, -1] = nb                                   # a sentinel entry
    lens = np.array([s, 7], np.int32)
    kw = dict(src_shift=s - lens) if src == "shift" else \
        dict(src_ring=True) if src == "ring" else {}
    want = RL.paged_pack(jnp.asarray(arena), jnp.asarray(kvs), jnp.asarray(tables),
                         jnp.asarray(lens), window=window,
                         **{k: jnp.asarray(v) if k == "src_shift" else v
                            for k, v in kw.items()})
    got = cache_from_jax({"k": arena, "v": kvs}, device="cpu")
    L.paged_pack(got["k"], got["v"], torch.as_tensor(tables), torch.as_tensor(lens),
                 window=window, **{k: torch.as_tensor(v) if k == "src_shift" else v
                                   for k, v in kw.items()})
    np.testing.assert_array_equal(_np(got["k"]), np.asarray(want))


@pytest.mark.parametrize("lane", LANES)
def test_paged_adopt_row_matches_reference(lane):
    """A batch-1 linear posit16 prefill packed into fresh arena blocks of
    row 1, pattern for pattern (no second quantize); on the window lane a
    12-token prompt arrives in ring layout (``src_ring``)."""
    rc, tc = _cfgs(lane, "posit16")
    rp, tp = _params(lane)
    plen = 12 if lane == "window" else 7
    prompt = _prompts(tc, (plen,), 10)
    row_ref, _, _ = RefEngine(rc, rp, max_len=20).prefill(prompt)
    ref_pag = RefEngine(rc, rp, max_len=20, paged=True, block_size=4)
    w = ref_pag.table_width
    nb = 2 * w
    pool_ref = RT.init_paged_cache(rc, 2, 20, 4, nb)
    window = RT._paged_window(rc)
    src_ring = bool(window) and plen > min(20, window)
    block_ids = np.full((w,), nb, np.int32)
    used = w if ref_pag.window_lane else -(-plen // 4)
    block_ids[:used] = np.arange(nb - used, nb)[::-1]
    want = RKV.paged_adopt_row(pool_ref, row_ref, jnp.int32(1),
                               jnp.asarray(block_ids), window=window,
                               src_ring=src_ring)
    pool = cache_from_jax(jax.tree.map(np.asarray, pool_ref), device="cpu")
    row = cache_from_jax(jax.tree.map(np.asarray, row_ref), device="cpu")
    got = kvc.paged_adopt_row(pool, row, 1, block_ids, window=window,
                              src_ring=src_ring)
    _assert_same_cache(got, jax.tree.map(np.asarray, want))
    with pytest.raises(ValueError, match="not paged"):
        kvc.paged_adopt_row(row, row, 0, block_ids)


def test_quantize_dequantize_cache_match_reference():
    _, tc = _cfgs("dense")
    ref_f32 = _ref_linear_cache("dense", None, _prompts(tc, (6, 9), 12), 16)
    f32 = cache_from_jax(jax.tree.map(np.asarray, ref_f32), device="cpu")
    for name in ("posit16", "posit8"):
        want = RKV.quantize_cache(ref_f32, name)
        got = kvc.quantize_cache(f32, name)
        _assert_same_cache(got, jax.tree.map(np.asarray, want))
        _assert_same_cache(kvc.dequantize_cache(got, name),
                           jax.tree.map(np.asarray, RKV.dequantize_cache(want, name)))
        assert kvc.cache_bytes(got) == RKV.cache_bytes(want)
        assert kvc.cache_report(got) == RKV.cache_report(want)
    with pytest.raises(ValueError, match="conv_state"):
        kvc.quantize_cache({"k": torch.zeros((4, 8)),
                            "conv_state": torch.zeros((4,))}, "posit16")
    with pytest.raises(ValueError, match="my_table"):
        kvc.dequantize_cache({"k": torch.zeros((4, 8), dtype=torch.uint8),
                              "my_table": torch.zeros((4,), dtype=torch.uint8)},
                             "posit16")


def test_linear_surgery_ops_reject_paged_caches():
    _, tc = _cfgs("dense")
    cache = T.init_paged_cache(tc, 1, 16, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        kvc.compact(cache, target_len=8)
    with pytest.raises(ValueError, match="paged"):
        kvc.reset_slots(cache, np.array([True]))
    with pytest.raises(ValueError, match="paged"):
        kvc.adopt_row(cache, cache, 0)
