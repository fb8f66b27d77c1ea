"""The fused chunked-prefill arena read against the reference's chain.

``posit_codec.paged_read_plain`` (what ``paged_read`` runs on a CPU
tensor, and what the CUDA kernel ``csrc/posit_paged_read.cu`` is held to
on the card) must equal, bit for bit through an integer view so that NaN
patterns count, the reference's ``prefill_chunk`` ``load``:
``repro.models.layers.paged_gather``, the Pallas ``dequantize_2d`` in
interpret mode, ``astype(cdtype)`` and ``repro.models.transformer.
_zero_invalid``.  Seeded numpy arenas of random patterns (zero and NaR
included) on the dense (K, V), window (K, V with the ring's ``low_pos``
> 0) and MLA (``c_kv``, ``k_rope``) leaves; posit16 and posit8; f32 and
bf16 out; sentinel table entries and an all-masked row.  Then the port's
``prefill_chunk``, which reads through ``paged_read`` once per layer, is
held to the reference's at posit16 KV over a prompt long enough that the
window lane's read starts past position 0.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as RCFG
from repro.core.types import POSIT8 as R8, POSIT16 as R16
from repro.kernels.posit_codec import dequantize_2d
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch import configs as TCFG
from repro_torch.core.types import POSIT8, POSIT16, signed_view
from repro_torch.kernels import posit_codec
from repro_torch.models import transformer as T
from repro_torch.weights import cache_from_jax, params_from_jax

CFGS = {"posit16": (POSIT16, R16), "posit8": (POSIT8, R8)}
OUT = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# leaf feature shapes per lane (reduced widths)
FEATS = {"dense": ((2, 8), (2, 8)), "window": ((2, 8), (2, 8)),
         "mla": ((16,), (8,))}
B, BS, NB = 3, 4, 16


def _case(lane, cfg, seed):
    """Leaves of random patterns (zero and NaR planted), a virtual table
    with sentinel entries, ragged ``lens`` with an all-masked last row;
    the window lane's table and ``low_pos`` come from the reference's
    ``_chunk_virtual_tables`` on a 3-entry ring at lens past the ring."""
    rng = np.random.default_rng(seed)
    arenas = []
    for feat in FEATS[lane]:
        a = rng.integers(0, 1 << cfg.nbits, (NB, BS) + feat, dtype=np.int64)
        flat = a.reshape(NB, BS, -1)
        flat[:, 1, :4] = [0, cfg.nar_pattern, 1, cfg.mask]   # in every block
        arenas.append(a.astype({16: np.uint16, 8: np.uint8}[cfg.nbits]))
    if lane == "window":
        ring = np.array([[4, 7, 1], [2, 9, 5], [0, 3, 6]], np.int32)
        lens = np.array([18, 11, 0], np.int32)
        vt, low = RT._chunk_virtual_tables(jnp.asarray(ring), jnp.asarray(lens),
                                           BS, 8, 6, NB)
        vt, low = np.array(vt), np.asarray(low).astype(np.int64)
        assert low[0] > 0
    else:
        vt = rng.permutation(NB)[:B * 5].reshape(B, 5).astype(np.int32)
        vt[0, 3:] = NB                      # sentinel tail
        vt[1, 1] = NB                       # a sentinel inside the row
        lens = np.array([11, 3, 0], np.int32)
        low = np.zeros(B, np.int64)
    return arenas, vt, lens.astype(np.int64), low


def _reference_read(arena, vt, lens, low, rcfg, out_dtype):
    g = RL.paged_gather(jnp.asarray(arena), jnp.asarray(vt))      # (B, T, ...)
    shape = g.shape
    f = dequantize_2d(g.reshape(shape[0] * shape[1], -1), rcfg, interpret=True)
    f = f.reshape(shape).astype(out_dtype)
    apos = jnp.arange(shape[1])[None, :]
    resident = (apos < jnp.asarray(lens)[:, None]) & (apos >= jnp.asarray(low)[:, None])
    return np.asarray(RT._zero_invalid(f, resident))


def _bits(x):
    """Integer view of f32/bf16 values (numpy or torch)."""
    if isinstance(x, torch.Tensor):
        return x.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[x.dtype]).numpy()
    return x.view({4: np.int32, 2: np.int16}[x.dtype.itemsize])


def _assert_same_values(got, want):
    """Bit-equal, except that a NaN only has to be a NaN: the frameworks
    round an f32 NaN to different bf16 NaN patterns (torch's CPU cast
    0xFFFF, XLA's 0x7FC0)."""
    g_nan = np.isnan(got.float().numpy())
    np.testing.assert_array_equal(g_nan, np.isnan(np.asarray(want, np.float32)))
    np.testing.assert_array_equal(np.where(g_nan, 0, _bits(got)),
                                  np.where(g_nan, 0, _bits(want)))


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("kv", ["posit16", "posit8"])
@pytest.mark.parametrize("lane", ["dense", "window", "mla"])
def test_paged_read_plain_equals_reference_chain(lane, kv, out):
    cfg, rcfg = CFGS[kv]
    tdt, jdt = OUT[out]
    arenas, vt, lens, low = _case(lane, cfg, seed=len(lane) + cfg.nbits)
    got = posit_codec.paged_read_plain(
        [torch.from_numpy(a.astype(np.int64)).to(cfg.storage_dtype) for a in arenas],
        torch.from_numpy(vt), torch.from_numpy(lens), torch.from_numpy(low), cfg, tdt)
    assert len(got) == 2
    for g, a, feat in zip(got, arenas, FEATS[lane]):
        want = _reference_read(a, vt, lens, low, rcfg, jdt)
        assert g.dtype == tdt and tuple(g.shape) == (B, vt.shape[1] * BS) + feat
        _assert_same_values(g, want)
        assert not _bits(g)[-1].any()                 # all-masked row: +0
        assert np.isnan(g.float().numpy()).any()      # a NaR was read


def test_paged_read_plain_reads_value_arenas_without_decode():
    """``cfg=None``: the f32/bf16 KV lane's chain (gather, cast, mask)."""
    rng = np.random.default_rng(5)
    arena = rng.normal(size=(NB, BS, 2, 8)).astype(np.float32)
    vt = np.array([[3, 1, NB], [0, 2, 4], [NB, NB, NB]], np.int32)
    lens, low = np.array([6, 12, 0]), np.array([0, 4, 0])
    (got,) = posit_codec.paged_read_plain(
        [torch.from_numpy(arena)], torch.from_numpy(vt), torch.from_numpy(lens),
        torch.from_numpy(low), None, torch.bfloat16)
    g = RL.paged_gather(jnp.asarray(arena), jnp.asarray(vt)).astype(jnp.bfloat16)
    apos = jnp.arange(12)[None, :]
    want = RT._zero_invalid(g, (apos < lens[:, None]) & (apos >= low[:, None]))
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)))


def _cfgs(lane):
    arch = "minicpm3-4b" if lane == "mla" else "phi3-medium-14b"
    rc = RCFG.get_config(arch).reduced(compute_dtype="float32", kv_posit="posit16")
    tc = TCFG.get_config(arch).reduced(compute_dtype="float32", kv_posit="posit16")
    if lane == "window":
        rc = dataclasses.replace(rc, sliding_window=8, attn_chunk_kv=8)
        tc = dataclasses.replace(tc, sliding_window=8, attn_chunk_kv=8)
    return rc, tc


@pytest.mark.parametrize("lane", ["dense", "window", "mla"])
def test_prefill_chunk_reads_through_paged_read(lane, monkeypatch):
    """The port's ``prefill_chunk`` at posit16 KV against the reference's,
    within the model tests' atol = rtol = 1e-4 on the logits, over five
    chunks of a 20-token prompt (the window lane's read then starts at
    position 4); arenas bit-equal in layer 0.  ``paged_read`` is called
    once per layer per chunk, with both leaves."""
    rc, tc = _cfgs(lane)
    rp = RT.init_params(jax.random.PRNGKey(0), rc)
    tp = params_from_jax(jax.tree.map(np.asarray, rp), tc, device="cpu")
    max_len, b = 32, 2
    w = RT.paged_table_width(rc, BS, max_len)
    nb = b * w
    rcache = dict(RT.init_paged_cache(rc, b, max_len, BS, nb),
                  block_tables=jnp.asarray(np.arange(nb, dtype=np.int32)
                                           .reshape(b, w)[:, ::-1].copy()))
    tcache = cache_from_jax(jax.tree.map(np.asarray, rcache), device="cpu")
    calls = []
    read = posit_codec.paged_read

    def counted(arenas, *a):
        calls.append(len(arenas))
        return read(arenas, *a)

    monkeypatch.setattr(posit_codec, "paged_read", counted)
    vw = -(-max_len // BS)
    rng = np.random.default_rng(11)
    for nv in ([4, 4], [4, 4], [4, 3], [4, 0], [4, 0]):
        toks = rng.integers(1, rc.vocab, (b, 4)).astype(np.int32)
        nv = np.asarray(nv, np.int32)
        rcache, rl = RT.prefill_chunk(rp, rcache, jnp.asarray(toks), rc,
                                      jnp.asarray(nv), virtual_width=vw)
        tcache, tl = T.prefill_chunk(tp, tcache, torch.from_numpy(toks), tc,
                                     torch.from_numpy(nv), virtual_width=vw)
        live = nv > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(rl)[live],
                                   atol=1e-4, rtol=1e-4)
    assert calls == [2] * (5 * tc.n_layers)
    np.testing.assert_array_equal(tcache["lens"].numpy(), [20, 11])
    for key in T.arena_keys(tc):
        # as in tests/test_torch_model.py: a layer-0 pattern may sit one
        # step off where an f32 last-ulp difference meets a rounding edge
        got = signed_view(tcache[key][0]).numpy().astype(np.int64) & 0xFFFF
        diff = got - np.asarray(rcache[key][0]).astype(np.int64)
        assert (np.abs(diff) <= 1).all() and (diff == 0).mean() > 0.99
