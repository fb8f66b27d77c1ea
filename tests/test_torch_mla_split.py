"""The split-and-fold design of ``csrc/paged_attn_mla.cu``, on the CPU.

The MLA kernel splits each row's block table into runs of ``c`` entries,
walks each run for all query heads with its own online softmax and folds
the runs' partial states in split order (the dense lane's fold).  Here
the same algorithm runs on plain versions: the MLA partial walk
(``paged_decode_partial_mla_plain``) over each run's sub-table (every
other entry set to the sentinel), folded by ``fold_partials_plain``.  It
must agree with the whole-table plain walk and with the JAX Pallas
kernel (interpret mode) within atol = rtol = 1e-6 (all three sum in f32,
in different orders), with f32, posit16 and posit8 latents, runs that
are no divisor of W, a run made only of sentinels and an all-masked row
(exact zeros on every side).
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
SCALE = 24 ** -0.5


def _case(kv, seed):
    """B 4, H 5, rank 16, rope 8, bs 4, W 7: a sentinel tail on row 0,
    a hole of sentinels at entries 2..3 of row 1 with live blocks after
    it, ragged lens, and an all-masked last row."""
    rng = np.random.default_rng(seed)
    b, h, rank, rope, bs, w = 4, 5, 16, 8, 4, 7
    nb = b * w
    tables = rng.permutation(nb).astype(np.int32).reshape(b, w)
    tables[-1, :] = nb
    tables[0, -1] = nb
    tables[1, 2:4] = nb
    lens = np.asarray([23, 26, 13, 0], np.int32)
    apos = L.paged_apos(torch.from_numpy(tables), torch.from_numpy(lens),
                        bs, nb).numpy()
    c = rng.normal(size=(nb, bs, rank)).astype(np.float32)
    r = rng.normal(size=(nb, bs, rope)).astype(np.float32)
    q_lat = rng.normal(size=(b, h, rank)).astype(np.float32)
    q_rope = rng.normal(size=(b, h, rope)).astype(np.float32)
    if kv:
        cfg = L.pcfg(kv)
        c = posit_codec.quantize(torch.from_numpy(c), cfg).numpy()
        r = posit_codec.quantize(torch.from_numpy(r), cfg).numpy()
    return q_lat, q_rope, c, r, tables, apos, lens


def _split_and_fold(q_lat, q_rope, c, r, tables, apos, lens, *, pcfg, chunk):
    """The plain MLA walk over each run's sub-table, folded in split
    order."""
    nb, w = c.shape[0], tables.shape[1]
    ms, ls, accs = [], [], []
    for w0 in range(0, w, chunk):
        sub = torch.full_like(tables, nb)
        sub[:, w0:w0 + chunk] = tables[:, w0:w0 + chunk]
        m, l, acc = PA.paged_decode_partial_mla_plain(
            q_lat, q_rope, c, r, sub, apos, lens, pcfg=pcfg, scale=SCALE)
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    return PA.fold_partials_plain(torch.stack(ms, -1), torch.stack(ls, -1),
                                  torch.stack(accs, -2))


@pytest.mark.parametrize("kv", [None, "posit16", "posit8"])
@pytest.mark.parametrize("chunk", [1, 2, 3, 7])
def test_mla_split_and_fold_matches_whole_walk_and_reference(kv, chunk):
    arrays = _case(kv, seed=21)
    args = [torch.from_numpy(a) for a in arrays]
    pcfg = L.pcfg(kv) if kv else None
    got = _split_and_fold(*args, pcfg=pcfg, chunk=chunk).numpy()
    whole = PA.paged_decode_attention_mla_plain(*args, pcfg=pcfg,
                                                scale=SCALE).numpy()
    ref = np.asarray(RPA.paged_decode_attention_mla(
        *(jnp.asarray(a) for a in arrays),
        pcfg={"posit16": R16, "posit8": R8}.get(kv), scale=SCALE,
        interpret=True))
    np.testing.assert_allclose(got, whole, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    assert (got[-1] == 0).all() and (whole[-1] == 0).all() \
        and (ref[-1] == 0).all()


@pytest.mark.parametrize("kv", [None, "posit16"])
def test_mla_partial_state_of_an_empty_run_is_identity(kv):
    """A run of sentinels leaves m at -1e30 and l, acc at 0 for every
    head (the fold then gives it weight 0), and the whole table's
    partial state normalises to the plain output."""
    arrays = _case(kv, seed=22)
    q_lat, q_rope, c, r, tables, apos, lens = (torch.from_numpy(a)
                                               for a in arrays)
    pcfg = L.pcfg(kv) if kv else None
    empty = torch.full_like(tables, c.shape[0])
    m, l, acc = PA.paged_decode_partial_mla_plain(
        q_lat, q_rope, c, r, empty, apos, lens, pcfg=pcfg, scale=SCALE)
    assert torch.all(m == -1e30) and torch.all(l == 0) and torch.all(acc == 0)
    m, l, acc = PA.paged_decode_partial_mla_plain(
        q_lat, q_rope, c, r, tables, apos, lens, pcfg=pcfg, scale=SCALE)
    out = PA.paged_decode_attention_mla_plain(q_lat, q_rope, c, r, tables,
                                              apos, lens, pcfg=pcfg,
                                              scale=SCALE)
    assert torch.equal(acc / torch.clamp(l, min=1e-30)[..., None], out)


@pytest.mark.parametrize("w,rows,sms,want", [
    (64, 8, 132, 4), (64, 2, 132, 1), (12, 4, 132, 1), (64, 64, 132, 32),
    (64, 8, 66, 8), (256, 8, 132, 16), (3, 512, 132, 3), (1024, 64, 132, 32)])
def test_split_chunk_mla_policy(w, rows, sms, want):
    """On the H100's 132 SMs minicpm3's decode case (B 8, W 64) walks 4
    entries per CTA (16 splits, 128 CTAs: one wave); small grids split
    to single entries; never above 32 or W; a card with half the SMs
    takes twice the entries."""
    assert PA.split_chunk_mla(w, rows, sms) == want
