"""The port's quire dot and ``pgemm`` at the library boundary
(``repro_torch.kernels.ops``) against the reference's
(``repro.kernels.ops``, Pallas kernels in interpret mode), bit-exact:
reductions across the 4096-element tile boundary, rank-1 and batched
broadcast, rank polymorphism, empty dimensions (an empty quire is posit
zero), and ``pgemm(a, w)[i, j] == dot(a[i], w[:, j])``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import types as RT
from repro.kernels import ops as R
from repro_torch.core import types as TT
from repro_torch.kernels import ops as T

NP = {8: np.uint8, 16: np.uint16, 32: np.uint32}
CFGS = {"posit8": (RT.POSIT8, TT.POSIT8), "posit16": (RT.POSIT16, TT.POSIT16),
        "posit32": (RT.POSIT32, TT.POSIT32)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small int64 ops per call: under the suite's parallel workers
    torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** cfg.nbits, size=shape,
                        dtype=np.uint64).astype(NP[cfg.nbits])


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(t):
    return TT.signed_view(t).numpy().view(
        {torch.uint8: np.uint8, torch.uint16: np.uint16,
         torch.uint32: np.uint32}[t.dtype])


@pytest.mark.parametrize("length", [1, 16, 33, 4095, 4096, 4097])
def test_dot_matches_reference_across_tiles(length):
    rcfg, tcfg = CFGS["posit16"]
    a, b = _rand(rcfg, (3, length), length), _rand(rcfg, (3, length), length + 1)
    a[a == rcfg.nar_pattern] = 0
    want = np.asarray(R.dot(jnp.asarray(a), jnp.asarray(b), rcfg))
    np.testing.assert_array_equal(_np(T.dot(_t(a), _t(b), tcfg)), want)
    np.testing.assert_array_equal(_np(T.dot_rows(_t(a), _t(b), tcfg)), want)


def test_dot_rank1_batched_broadcast_and_empty():
    rcfg, tcfg = CFGS["posit16"]
    a, b = _rand(rcfg, (2, 3, 40), 13), _rand(rcfg, (2, 3, 40), 14)
    vec = b[0, 0]
    for x, y in ((a, b), (a, vec), (a[0, 0], vec)):
        want = np.asarray(R.dot(jnp.asarray(x), jnp.asarray(y), rcfg))
        got = T.dot(_t(x), _t(y), tcfg)
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(_np(got), want)
    z = lambda *s: torch.zeros(s, dtype=torch.int16).view(torch.uint16)  # noqa: E731
    got = T.dot(z(3, 0), z(3, 0), tcfg)
    assert got.shape == (3,) and (_np(got) == 0).all()
    assert T.dot(z(0, 7), z(0, 7), tcfg).shape == (0,)
    with pytest.raises(ValueError, match="rank >= 1"):
        T.dot(z(), z(), tcfg)


@pytest.mark.parametrize("name", ["posit8", "posit16", "posit32"])
@pytest.mark.parametrize("mkn", [(5, 37, 7), (16, 64, 16)])
def test_pgemm_matches_reference(name, mkn):
    rcfg, tcfg = CFGS[name]
    m, k, n = mkn
    a, w = _rand(rcfg, (m, k), m + k), _rand(rcfg, (k, n), k + n)
    want = np.asarray(R.pgemm(jnp.asarray(a), jnp.asarray(w), rcfg))
    got = T.pgemm(_t(a), _t(w), tcfg)
    assert got.dtype == tcfg.storage_dtype
    np.testing.assert_array_equal(_np(got), want)


def test_pgemm_long_k_and_pgemm_equals_dot_per_output():
    """K across two quire tiles (ragged) against the reference's lattice
    oracle, and ``pgemm(a, w)[i, j] == dot(a[i], w[:, j])`` bit for bit."""
    from repro.kernels import ref
    rcfg, tcfg = CFGS["posit16"]
    a, w = _rand(rcfg, (2, 4200), 20), _rand(rcfg, (4200, 3), 21)
    want = np.asarray(jax.jit(lambda x, y: ref.pgemm_ref(x, y, rcfg))(
        jnp.asarray(a), jnp.asarray(w)))
    got = T.pgemm(_t(a), _t(w), tcfg)
    np.testing.assert_array_equal(_np(got), want)
    per_out = T.dot(_t(a)[:, None, :], _t(np.ascontiguousarray(w.T))[None], tcfg)
    np.testing.assert_array_equal(_np(per_out), _np(got))


def test_pgemm_rank_polymorphic_and_empty():
    rcfg, tcfg = CFGS["posit8"]
    a, w = _rand(rcfg, (2, 3, 24), 22), _rand(rcfg, (24, 5), 23)
    got = T.pgemm(_t(a), _t(w), tcfg)
    assert got.shape == (2, 3, 5)
    np.testing.assert_array_equal(
        _np(got).reshape(6, 5), _np(T.pgemm(_t(a.reshape(6, 24)), _t(w), tcfg)))
    vec = T.pgemm(_t(a[0, 0]), _t(w), tcfg)
    assert vec.shape == (5,) and (_np(vec) == _np(got)[0, 0]).all()
    z = lambda *s: torch.zeros(s, dtype=torch.uint8)  # noqa: E731
    assert (_np(T.pgemm(z(2, 0), z(0, 4), tcfg)) == 0).all()
    assert T.pgemm(z(0, 5), z(5, 4), tcfg).shape == (0, 4)
    assert T.pgemm(z(2, 5), z(5, 0), tcfg).shape == (2, 0)
    with pytest.raises(ValueError, match="contraction"):
        T.pgemm(z(2, 5), z(4, 3), tcfg)
