"""The split-and-fold design of ``csrc/paged_attn.cu``, on the CPU.

The kernel splits each row's block table into runs of ``c`` entries,
walks each run with its own online softmax and folds the runs' partial
states in split order.  Here the same algorithm runs on plain versions:
the plain table walk over each run's sub-table (every other entry set
to the sentinel), folded by the fold's plain version.  It must agree
with the whole-table plain walk and with the JAX Pallas kernel (interpret
mode) within atol = rtol = 1e-6, on the dense and window lanes, with f32,
posit16 and posit8 KV, runs that are no divisor of W, a run made only of
sentinels and an all-masked row (exact zeros on every side).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.types import POSIT8 as R8, POSIT16 as R16
from repro.kernels import posit_paged_attn as RPA
from repro_torch.kernels import posit_codec, posit_paged_attn as PA
from repro_torch.models import layers as L

TOL = 1e-6


def _case(kv, window, seed):
    """B 4, G 2, R 2, D 16, bs 4; W 7 dense (a hole of sentinels at
    entries 2..3 of row 1, a sentinel tail on row 0) or the 3-block
    window ring at window 8 (lens that wrap it); the last row all
    sentinels."""
    rng = np.random.default_rng(seed)
    g, r, d, bs = 2, 2, 16, 4
    b = 4
    w = L.paged_window_blocks(window, bs) if window else 7
    nb = b * w
    tables = rng.permutation(nb).astype(np.int32).reshape(b, w)
    tables[-1, :] = nb
    tables[0, -1] = nb
    if window:
        lens = [13, 2, 22, 0]
    else:
        tables[1, 2:4] = nb
        lens = [23, 26, 27, 0]
    lens = np.asarray(lens, np.int32)
    apos = L.paged_apos(torch.from_numpy(tables), torch.from_numpy(lens),
                        bs, nb, window=window).numpy()
    k = rng.normal(size=(nb, bs, g, d)).astype(np.float32)
    v = rng.normal(size=(nb, bs, g, d)).astype(np.float32)
    q = (rng.normal(size=(b, g, r, d)) * d ** -0.5).astype(np.float32)
    if kv:
        cfg = L.pcfg(kv)
        k = posit_codec.quantize(torch.from_numpy(k), cfg).numpy()
        v = posit_codec.quantize(torch.from_numpy(v), cfg).numpy()
    return q, k, v, tables, apos, lens


def _split_and_fold(q, k, v, tables, apos, lens, *, pcfg, window, chunk):
    """The plain walk over each run's sub-table, folded in split order."""
    nb, w = k.shape[0], tables.shape[1]
    ms, ls, accs = [], [], []
    for w0 in range(0, w, chunk):
        sub = torch.full_like(tables, nb)
        sub[:, w0:w0 + chunk] = tables[:, w0:w0 + chunk]
        m, l, acc = PA.paged_decode_partial_plain(q, k, v, sub, apos, lens,
                                                  pcfg=pcfg, window=window)
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    return PA.fold_partials_plain(torch.stack(ms, -1), torch.stack(ls, -1),
                                  torch.stack(accs, -2))


@pytest.mark.parametrize("kv", [None, "posit16", "posit8"])
@pytest.mark.parametrize("window", [0, 8], ids=["dense", "window-wrap"])
@pytest.mark.parametrize("chunk", [1, 2, 3, 7])
def test_split_and_fold_matches_whole_walk_and_reference(kv, window, chunk):
    arrays = _case(kv, window, seed=11)
    q, k, v, tables, apos, lens = (torch.from_numpy(a) for a in arrays)
    pcfg = L.pcfg(kv) if kv else None
    got = _split_and_fold(q, k, v, tables, apos, lens, pcfg=pcfg,
                          window=window, chunk=chunk).numpy()
    whole = PA.paged_decode_attention_plain(q, k, v, tables, apos, lens,
                                            pcfg=pcfg, window=window).numpy()
    ref = np.asarray(RPA.paged_decode_attention(
        *(jnp.asarray(a) for a in arrays),
        pcfg={"posit16": R16, "posit8": R8}.get(kv), window=window,
        interpret=True))
    np.testing.assert_allclose(got, whole, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    assert (got[-1] == 0).all() and (whole[-1] == 0).all() \
        and (ref[-1] == 0).all()


def test_fold_of_empty_splits_is_exact_zeros_and_ignores_their_max():
    """Splits with l == 0 weigh nothing whatever their m; a lone live
    split folds to its own acc / l."""
    m = torch.tensor([[-1e30, 3.0, -1e30], [-1e30, -1e30, -1e30]])
    l = torch.tensor([[0.0, 2.0, 0.0], [0.0, 0.0, 0.0]])
    acc = torch.zeros(2, 3, 5)
    acc[0, 1] = torch.arange(5.0)
    out = PA.fold_partials_plain(m, l, acc)
    assert torch.equal(out[0], torch.arange(5.0) / 2.0)
    assert torch.equal(out[1], torch.zeros(5))


@pytest.mark.parametrize("w,rows,sms,want", [
    (64, 80, 132, 4), (64, 8, 132, 1), (12, 6, 132, 1), (64, 2048, 132, 32),
    (3, 4096, 132, 3), (256, 80, 132, 16), (64, 80, 66, 8)])
def test_split_chunk_policy(w, rows, sms, want):
    """On the H100's 132 SMs, phi3's decode case (B 8 x G 10, W 64) walks
    4 entries per CTA, 16 splits; small grids split to single entries;
    never above 32 or W; a card with half the SMs takes twice the
    entries."""
    assert PA.split_chunk(w, rows, sms) == want
