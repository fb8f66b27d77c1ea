"""The port's paged-KV primitives against ``repro.models.layers``.

Integer outputs (positions, apos) and pattern arenas must be equal: the
primitives only move bytes.  Writes through sentinel table entries and
rows with ``ok=False`` are dropped on both sides, never clamped onto
another row's block.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import layers as RL
from repro_torch.compress import kvcache as TKV
from repro_torch.models import layers as L

BS = 4


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("window,w", [(0, 5), (8, 3)], ids=["dense", "window"])
def test_paged_positions_and_apos(window, w):
    frontier = np.array([0, 3, 13, 22, 7], np.int32)
    ref = _np(RL.paged_positions(jnp.asarray(frontier), w, BS, window=window))
    got = L.paged_positions(torch.from_numpy(frontier), w, BS,
                            window=window).numpy()
    np.testing.assert_array_equal(got, ref)

    nb = 20
    tables = np.arange(5 * w, dtype=np.int32).reshape(5, w) % nb
    tables[1, 1:] = nb
    tables[4, :] = nb
    ref = _np(RL.paged_apos(jnp.asarray(tables), jnp.asarray(frontier), BS, nb,
                            window=window))
    got = L.paged_apos(torch.from_numpy(tables), torch.from_numpy(frontier),
                       BS, nb, window=window)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def _arena(rng, nb, posit):
    x = rng.integers(0, 1 << 16, (nb, BS, 2, 3))
    return x.astype(np.uint16) if posit else x.astype(np.float32)


@pytest.mark.parametrize("posit", [False, True], ids=["f32", "posit16"])
@pytest.mark.parametrize("window,w", [(0, 5), (8, 3)], ids=["dense", "window"])
def test_paged_cache_update_drops_sentinel_and_inactive(posit, window, w):
    rng = np.random.default_rng(0)
    nb = 12
    arena = _arena(rng, nb, posit)
    b = 4
    tables = np.full((b, w), nb, np.int32)
    tables[0, :2] = [3, 7]
    tables[1, :1] = [5]                        # pos 9 -> slot 2 (sentinel)
    tables[2, :3] = [0, 1, 2]
    tables[3, :3] = [8, 9, 10]
    pos = np.array([5, 9, 11, 2], np.int32)
    ok = np.array([True, True, True, False])   # row 3 inactive
    upd = _arena(rng, b, posit)[:, 0]
    ref = _np(RL.paged_cache_update(jnp.asarray(arena), jnp.asarray(upd),
                                    jnp.asarray(tables), jnp.asarray(pos),
                                    jnp.asarray(ok), window=window))
    got = L.paged_cache_update(torch.from_numpy(arena.copy()),
                               torch.from_numpy(upd), torch.from_numpy(tables),
                               torch.from_numpy(pos), torch.from_numpy(ok),
                               window=window).numpy()
    np.testing.assert_array_equal(got, ref)
    changed = (got != arena).reshape(nb, -1).any(-1)
    assert not changed[[5, 8, 9, 10]].any()    # dropped writes left intact


@pytest.mark.parametrize("posit", [False, True], ids=["f32", "posit16"])
@pytest.mark.parametrize("window,w", [(0, 6), (8, 3)], ids=["dense", "window"])
def test_paged_pack_range_matches_reference(posit, window, w):
    """Suffix packing writes only ``[start, lens)``; the window lane
    writes only the latest ring epoch; sentinel entries drop."""
    rng = np.random.default_rng(1)
    nb, n_layers, s = 24, 2, 8
    arena = rng.integers(0, 1 << 16, (n_layers, nb, BS, 2, 3))
    arena = arena.astype(np.uint16 if posit else np.float32)
    b = 4
    tables = np.arange(b * w, dtype=np.int32).reshape(b, w)
    tables[1, -1] = nb
    start = np.array([0, 5, 9, 3], np.int32)
    lens = np.array([7, 13, 9, 11], np.int32)     # row 2: nothing to write
    kvs = rng.integers(0, 1 << 16, (n_layers, b, s, 2, 3))
    kvs = kvs.astype(arena.dtype)
    ref = _np(RL.paged_pack_range(jnp.asarray(arena), jnp.asarray(kvs),
                                  jnp.asarray(tables), jnp.asarray(start),
                                  jnp.asarray(lens), window=window))
    got = L.paged_pack_range(torch.from_numpy(arena.copy()),
                             torch.from_numpy(kvs), torch.from_numpy(tables),
                             torch.from_numpy(start), torch.from_numpy(lens),
                             window=window).numpy()
    np.testing.assert_array_equal(got, ref)


def test_paged_gather_clamps_sentinels():
    rng = np.random.default_rng(2)
    nb = 6
    arena = rng.integers(0, 1 << 16, (nb, BS, 2, 3)).astype(np.uint16)
    tables = np.array([[0, 5, nb], [nb, nb, 2]], np.int32)
    ref = _np(RL.paged_gather(jnp.asarray(arena), jnp.asarray(tables)))
    got = L.paged_gather(torch.from_numpy(arena), torch.from_numpy(tables))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_block_pool_refcounts_and_sanitizer():
    pool = TKV.BlockPool(4, sanitize=True)
    a = pool.alloc(2)
    assert a == [0, 1] and pool.n_free == 2
    pool.share([a[0]])
    assert pool.free([a[0]]) == [] and pool.refcount(a[0]) == 1
    assert pool.free(a) == [0, 1] and pool.n_free == 4
    with pytest.raises(TKV.BlockSanitizerError, match="double free"):
        pool.free([0])
    with pytest.raises(TKV.BlockSanitizerError, match="use-after-free"):
        pool.check_read([1])
    b = pool.alloc(1)
    assert pool.allocated_ids() == b
    pool.share(b)
    with pytest.raises(TKV.BlockSanitizerError, match="COW violation"):
        pool.check_write(b)
    with pytest.raises(MemoryError):
        pool.alloc(4)
    assert pool.peak_in_use == 2 and pool.peak_logical == 3
