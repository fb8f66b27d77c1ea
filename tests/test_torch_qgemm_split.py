"""A host mirror of ``csrc/posit_qgemm.cu``'s design, on plain tensors.

The kernel splits each output's K into quire tiles of MAX_DOT_LENGTH
that run in parallel, writes every tile's state to a workspace and folds
the states in tile order from k = 0 before the one rounding.  Inside a
tile its exponent pass takes the maximum of the operands' exponent sums
with a zero operand's exponent set to ``kZeroExp`` (sums below -2^28
stand for the empty sentinel), and carries NaR as row and column flags;
its placing pass treats an operand whose significand is 0 (zero or NaR)
as zero.  The mirror does the same with ``repro_torch.core.dot``'s
pieces, checks every tile state against ``quire_partial`` field by
field, folds, finalizes, and must equal ``posit_qgemm_plain`` and the
reference's Pallas ``posit_qgemm`` in interpret mode bit for bit, at K
on both sides of one, two and three tile boundaries, in posit8, posit16
and posit32, with NaR, zero rows and columns, an all-zero middle tile
and maxpos/minpos planted.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import types as RT
from repro.kernels.posit_qgemm import posit_qgemm as ref_qgemm
from repro_torch.core import dot as D, u64
from repro_torch.core.pir import PIR, decode, encode_pir
from repro_torch.core.types import POSIT8, POSIT16, POSIT32, signed_view, to_storage
from repro_torch.kernels.posit_qgemm import posit_qgemm_plain

CFGS = {"posit8": (RT.POSIT8, POSIT8), "posit16": (RT.POSIT16, POSIT16),
        "posit32": (RT.POSIT32, POSIT32)}
NP = {8: np.uint8, 16: np.uint16, 32: np.uint32}
ZERO_EXP = -(1 << 29)                       # the kernel's kZeroExp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small int64 ops per call: under the suite's parallel workers
    torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(cfg, m, k, n, seed):
    """Seeded patterns with the edges planted: a NaR in row 0's last
    tile, a zero column, row 1 zero in its second tile (an empty middle
    state when K spans three tiles), row 2 half maxpos and minpos."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << cfg.nbits, (m, k), dtype=np.uint64).astype(np.int64)
    w = rng.integers(0, 1 << cfg.nbits, (k, n), dtype=np.uint64).astype(np.int64)
    a[a == cfg.nar_pattern] = 1
    w[w == cfg.nar_pattern] = cfg.maxpos_pattern
    a[0, k - 1] = cfg.nar_pattern
    w[:, 1] = 0
    a[1, D.MAX_DOT_LENGTH:2 * D.MAX_DOT_LENGTH] = 0
    a[2, ::2] = cfg.maxpos_pattern
    a[2, 1::4] = 1
    return a, w


def _tile_state(pa, pw):
    """One tile's (m, n) states as the kernel computes them."""
    # exponent pass: exponent sums with zero operands at ZERO_EXP
    ex_a = torch.where(pa.is_zero, ZERO_EXP, pa.exp)
    ex_w = torch.where(pw.is_zero, ZERO_EXP, pw.exp)
    m_exp = (ex_a[:, :, None] + ex_w[None]).amax(1)
    m_exp = torch.where(m_exp < -(1 << 28), D._EXP_SENTINEL, m_exp)
    nar = pa.is_nar.any(1)[:, None] | pw.is_nar.any(0)[None, :]
    # placing pass: operands with a zero significand count as zero
    sig_a, sig_w = pa.sig[:, :, None], pw.sig[None]
    pzero = (sig_a == 0) | (sig_w == 0)
    prod = u64.mul_32x32(sig_a.expand(pzero.shape), sig_w.expand(pzero.shape))
    d = (m_exp[:, None, :] - (pa.exp[:, :, None] + pw.exp[None])).clamp(0, 95)
    limbs, st = D._place_product(prod, d)
    limbs = [torch.where(pzero, 0, x) for x in limbs]
    st = torch.where(pzero, 0, st)
    neg = (pa.sign[:, :, None] ^ pw.sign[None]) == 1
    limbs = [torch.where(neg, x, y) for x, y in zip(D._neg_n(limbs), limbs)]
    limbs = D._sub1_128(limbs, (neg & (st == 1)).to(st.dtype))
    return D.QuireState(acc=torch.stack(D._sum_n(limbs, 1), dim=-1), m_exp=m_exp,
                        sticky=st.amax(1), nar=nar)


def mirror_pgemm(a, w, cfg):
    """pgemm by the kernel's split: tile states into a workspace, checked
    against ``quire_partial``; the fold in tile order; one rounding."""
    pa, pw = decode(a, cfg), decode(w, cfg)
    k = a.shape[1]
    workspace = []
    for t0 in range(0, k, D.MAX_DOT_LENGTH):
        t1 = min(t0 + D.MAX_DOT_LENGTH, k)
        ta = PIR(*(f[:, t0:t1] for f in pa))
        tw = PIR(*(f[t0:t1] for f in pw))
        state = _tile_state(ta, tw)
        want = D.quire_partial(PIR(*(f[:, :, None] for f in ta)),
                               PIR(*(f[None] for f in tw)), dim=1)
        for got_f, want_f in zip(state, want):
            assert torch.equal(got_f, want_f.to(got_f.dtype))
        workspace.append(state)
    m, n = a.shape[0], w.shape[1]
    s = D.QuireState(acc=torch.zeros((m, n, 4), dtype=torch.int64),
                     m_exp=torch.full((m, n), D._EXP_SENTINEL, dtype=torch.int64),
                     sticky=torch.zeros((m, n), dtype=torch.int64),
                     nar=torch.zeros((m, n), dtype=torch.bool))
    for state in workspace:
        s = D.quire_combine(s, state)
    pir, sticky = D.quire_finalize(s)
    return to_storage(encode_pir(pir, cfg, sticky), cfg.storage_dtype)


@pytest.mark.parametrize("k", [4095, 4096, 4097, 8193, 12289])
@pytest.mark.parametrize("name", ["posit8", "posit16", "posit32"])
def test_split_fold_equals_plain_and_reference(name, k):
    rcfg, cfg = CFGS[name]
    a, w = _operands(cfg, 3, k, 5, seed=k + cfg.nbits)
    ta, tw = (to_storage(torch.from_numpy(x), cfg.storage_dtype) for x in (a, w))
    got = signed_view(mirror_pgemm(ta, tw, cfg))
    assert torch.equal(got, signed_view(posit_qgemm_plain(ta, tw, cfg)))
    want = np.asarray(ref_qgemm(jnp.asarray(a.astype(NP[cfg.nbits])),
                                jnp.asarray(w.astype(NP[cfg.nbits])), rcfg,
                                interpret=True))
    np.testing.assert_array_equal(got.numpy().astype(np.int64) & cfg.mask,
                                  want.astype(np.int64))
    mask = cfg.mask
    out = got.numpy().astype(np.int64) & mask
    assert (out[0] == cfg.nar_pattern).all()          # the NaR row
    assert out[1:, 1].tolist() == [0, 0]              # the zero column
