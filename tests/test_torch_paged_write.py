"""The fused quantize-and-write's plain path against the reference.

On the card, ``kernels.posit_codec.paged_write`` quantizes KV rows and
stores the patterns straight into their arena slots
(``csrc/posit_paged_write.cu``), with destinations in dense form
(``layers.paged_write_slots`` / ``paged_pack_slots``: a flat slot, or -1
to drop) so it needs no host sync.  On the CPU it runs its plain
version, ``paged_write_plain``: ``quantize_plain`` and the masked
scatter.  The arenas it leaves must equal, bit for bit, the reference's
``_maybe_quant_kv`` followed by its cache write -- ``paged_cache_update``
for a decode token, ``paged_pack_range`` for a prefill chunk -- on the
dense, window-wrap and MLA leaves, in posit16 and posit8, with inactive
rows and sentinel entries; and the dense destinations drop exactly the
writes the reference (and ``paged_write_index``) drops.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import configs as RCFG
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.kernels import posit_codec as C
from repro_torch.models import layers as L

BS = 4
NB = 24
# lane -> (the two leaves' per-slot shapes, window, table width)
LANES = {"dense": (((2, 8), (2, 8)), 0, 6),
         "window-wrap": (((2, 8), (2, 8)), 8, 3),
         "mla": (((16,), (8,)), 0, 6)}


def _ref_cfg(kv):
    return dataclasses.replace(
        RCFG.get_config("phi3-medium-14b").reduced(compute_dtype="float32"),
        kv_posit=kv)


def _arenas(rng, feats, kv, lead=()):
    cfg = L.pcfg(kv)
    return [C.quantize_plain(torch.from_numpy(
        rng.normal(size=lead + (NB, BS) + f).astype(np.float32)), cfg).numpy()
        for f in feats]


def _tables(rng, w, b):
    tables = rng.permutation(NB)[:b * w].astype(np.int32).reshape(b, w)
    tables[1, 1] = NB                   # row 1 writes through a sentinel
    tables[2, -1] = NB
    return tables


@pytest.mark.parametrize("kv", ["posit16", "posit8"])
@pytest.mark.parametrize("lane", list(LANES))
def test_decode_write_matches_reference_quantize_then_cache_update(kv, lane):
    feats, window, w = LANES[lane]
    rng = np.random.default_rng(3)
    b = 4
    arenas = _arenas(rng, feats, kv)
    tables = _tables(rng, w, b)
    pos = np.array([5, 5, 11 if not window else 21, 2], np.int32)
    ok = np.array([True, True, True, False])           # row 3 inactive
    new = [rng.normal(size=(b,) + f).astype(np.float32) for f in feats]
    rc = _ref_cfg(kv)
    ref = [np.asarray(RL.paged_cache_update(
        jnp.asarray(a), RT._maybe_quant_kv(jnp.asarray(x), rc),
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(ok), window=window))
        for a, x in zip(arenas, new)]
    got = [torch.from_numpy(a.copy()) for a in arenas]
    slots = L.paged_write_slots(torch.from_numpy(tables), torch.from_numpy(pos),
                                torch.from_numpy(ok), n_blocks=NB,
                                block_size=BS, window=window)
    C.paged_write([(a, torch.from_numpy(x)) for a, x in zip(got, new)], slots,
                  L.pcfg(kv))
    for g, r, a in zip(got, ref, arenas):
        np.testing.assert_array_equal(g.numpy(), r)
        changed = (g.numpy() != a).reshape(NB * BS, -1).any(-1)
        assert changed.sum() <= 2                      # rows 0 and 2 only


@pytest.mark.parametrize("kv", ["posit16", "posit8"])
@pytest.mark.parametrize("lane", list(LANES))
def test_prefill_write_matches_reference_pack_range_of_quantized(kv, lane):
    """One launch per leaf over every layer: the chunk's rows flattened,
    destinations from ``paged_pack_slots``; equal to the reference's
    quantize then ``paged_pack_range``."""
    feats, window, w = LANES[lane]
    rng = np.random.default_rng(4)
    b, s, n_layers = 4, 6, 3
    arenas = _arenas(rng, feats, kv, lead=(n_layers,))
    tables = _tables(rng, w, b)
    start = np.array([0, 3, 9, 2], np.int32)
    lens = np.array([6, 9, 9, 8], np.int32)
    if window:
        start = np.array([10, 3, 9, 18], np.int32)
        lens = np.array([16, 9, 9, 22], np.int32)
    kvs = [rng.normal(size=(n_layers, b, s) + f).astype(np.float32)
           for f in feats]
    rc = _ref_cfg(kv)
    ref = [np.asarray(RL.paged_pack_range(
        jnp.asarray(a), RT._maybe_quant_kv(jnp.asarray(x), rc),
        jnp.asarray(tables), jnp.asarray(start), jnp.asarray(lens),
        window=window)) for a, x in zip(arenas, kvs)]
    slots = L.paged_pack_slots(torch.from_numpy(tables), torch.from_numpy(start),
                               torch.from_numpy(lens), s, n_blocks=NB,
                               block_size=BS, window=window).reshape(-1)
    got = [torch.from_numpy(a.copy()) for a in arenas]
    for a, x in zip(got, kvs):
        x = torch.from_numpy(x)
        C.paged_write([(a[li], x[li].reshape((b * s,) + x.shape[3:]))
                       for li in range(n_layers)], slots, L.pcfg(kv))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)


@pytest.mark.parametrize("window,w", [(0, 5), (8, 3)], ids=["dense", "window"])
def test_dense_destinations_drop_exactly_what_the_index_drops(window, w):
    """``paged_write_slots`` marks -1 exactly the rows
    ``paged_write_index`` leaves out (inactive, past the table, through
    a sentinel) and names the same (block, offset) for the others; the
    same for ``paged_pack_slots`` against the positions
    ``paged_pack_range`` writes."""
    b, nb = 6, 32
    tables = torch.arange(b * w, dtype=torch.int32).reshape(b, w)
    tables[1, 2 % w] = nb
    tables[4, :] = nb
    pos = torch.tensor([3, 9, 13, 22, 7, 40], dtype=torch.int32)
    ok = torch.tensor([True, True, True, True, True, False])
    geo = dict(n_blocks=nb, block_size=BS, window=window)
    slots = L.paged_write_slots(tables, pos, ok, **geo)
    rows, blocks, offs = L.paged_write_index(tables, pos, ok, **geo)
    assert slots.dtype == torch.int64
    assert torch.equal(torch.nonzero(slots >= 0)[:, 0], rows)
    assert torch.equal(slots[rows], blocks * BS + offs)
    dropped = set(range(b)) - set(rows.tolist())
    assert {1, 4, 5} <= dropped

    start = torch.tensor([0, 5, 9, 2, 0, 1])
    lens = torch.tensor([6, 13, 9, 8, 4, 30])
    s = 8
    pslots = L.paged_pack_slots(tables, start, lens, s, **geo)
    # paged_pack_range writes each kept position's own value: mark every
    # slot with its (row, t) and read back where they landed
    arena = torch.full((1, nb, BS, 1), -1.0)
    kvs = torch.arange(b * s, dtype=torch.float32).reshape(1, b, s, 1)
    L.paged_pack_range(arena, kvs, tables, start, lens, window=window)
    landed = {int(v): i for i, v in enumerate(arena.reshape(-1).tolist())
              if v >= 0}
    want = {i: int(v) for i, v in enumerate(pslots.reshape(-1).tolist())
            if v >= 0}
    assert landed == want
    assert len(want) < b * s                           # some writes drop


def test_paged_write_rejects_unsupported_configs():
    from repro_torch.core.types import POSIT32
    arena = torch.zeros((2, 4, 3), dtype=torch.uint32)
    with pytest.raises(ValueError, match="posit16 and posit8"):
        C._paged_write_call([(arena, torch.zeros(1, 3))],
                             torch.zeros(1, dtype=torch.int64), POSIT32)


def test_paged_write_refuses_mixed_devices():
    """The arenas' device chooses the path; a source or ``slots`` on
    another device raises instead of running the plain version there."""
    from repro_torch.core.types import POSIT16
    arena = torch.zeros((4, 2, 3), dtype=torch.uint16)
    src, slots = torch.zeros(2, 3), torch.zeros(2, dtype=torch.int64)
    for job, sl in (((arena.to("meta"), src), slots),
                    ((arena, src.to("meta")), slots),
                    ((arena, src), slots.to("meta"))):
        with pytest.raises(ValueError, match="share one device"):
            C.paged_write([job], sl, POSIT16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cast_write_lands_where_the_index_write_does(dtype):
    """f32/bf16 KV: the model's write (compute-dtype cast, scatter to the
    dense slots) leaves the arenas the index-form ``paged_write`` leaves,
    for a decode token and a prefill chunk of two layers."""
    from repro_torch import configs as TCFG
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(
        TCFG.get_config("phi3-medium-14b").reduced(compute_dtype=dtype), kv_posit=None)
    cd = L.cdtype(cfg)
    rng = np.random.default_rng(5)
    b, w, c = 4, 6, 5
    tables = torch.from_numpy(_tables(rng, w, b))
    pos = torch.tensor([3, 6, 13, 2])
    ok = torch.tensor([True, True, True, False])
    geo = dict(n_blocks=NB, block_size=BS)
    leaves = [torch.from_numpy(rng.normal(size=(2, NB, BS, 2, 8)).astype(np.float32)).to(cd)
              for _ in range(2)]
    one = [torch.from_numpy(rng.normal(size=(b, 2, 8)).astype(np.float32)) for _ in range(2)]
    chunk = [torch.from_numpy(rng.normal(size=(2, b, c, 2, 8)).astype(np.float32))
             for _ in range(2)]
    got = [a.clone() for a in leaves]
    want = [a.clone() for a in leaves]
    T._write_kv([(a[0], x) for a, x in zip(got, one)],
                L.paged_write_slots(tables, pos, ok, **geo), cfg)
    index = L.paged_write_index(tables, pos, ok, **geo)
    for a, x in zip(want, one):
        L.paged_write(a[0], x.to(cd), index)
    slots = L.paged_pack_slots(tables, pos, pos + 3, c, **geo).reshape(-1)
    for a, x in zip(got, chunk):
        T._write_kv([(a[li], x[li].reshape((b * c, 2, 8))) for li in range(2)], slots, cfg)
    for a, x in zip(want, chunk):
        L.paged_pack_range(a, x.to(cd), tables, pos, pos + 3)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert not torch.equal(got[0], leaves[0])
