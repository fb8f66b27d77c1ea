"""The port's PVU library boundary (``repro_torch.kernels.ops``) against the
reference's (``repro.kernels.ops``, Pallas kernels in interpret mode):
the fused elementwise ops, the codec and the posit-weight ``gemm``
(the quire dot and ``pgemm`` are in ``test_torch_pvu_dot.py``).

On CPU tensors every ``ops`` call runs its kernel's plain version, so
these hold the plain versions plus the boundary's shape handling
(broadcasting, rank polymorphism) to the reference.  Patterns must be
bit-exact; ``gemm`` is exact where the f32 sums are (small integers)
and otherwise within the f32 forward-error bound of two summation
orders.
"""
import numpy as np
import pytest
import torch

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


_EW = {"add": ("vadd", {}), "sub": ("vsub", {}), "mul": ("vmul", {}),
       "div_nr3": ("vdiv", {"mode": "nr3"}),
       "div_exact": ("vdiv", {"mode": "exact"})}


@pytest.mark.parametrize("op", sorted(_EW))
def test_elementwise_ops_match_reference_with_broadcast(op):
    """Same shapes, a scalar operand and a row operand (posit16)."""
    rcfg, tcfg = CFGS["posit16"]
    name, kw = _EW[op]
    a, b = _rand(rcfg, (6, 40), 1), _rand(rcfg, (6, 40), 2)
    a[0, :6] = [0, rcfg.nar_pattern, rcfg.maxpos_pattern, 1, 0xFFFF, 0x8001]
    for x, y in ((a, b), (a, b[2, 3]), (a, b[1]), (b[0, 0], a)):
        want = np.asarray(getattr(R, name)(jnp.asarray(x), jnp.asarray(y),
                                           rcfg, **kw))
        got = getattr(T, name)(_t(x), _t(np.asarray(y)), tcfg, **kw)
        assert got.shape == want.shape and got.dtype == tcfg.storage_dtype
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("name", ["posit8", "posit32"])
def test_elementwise_ops_other_widths(name):
    rcfg, tcfg = CFGS[name]
    a, b = _rand(rcfg, (3, 7), 3), _rand(rcfg, (3, 7), 4)
    for fn, kw in _EW.values():
        want = np.asarray(getattr(R, fn)(jnp.asarray(a), jnp.asarray(b), rcfg, **kw))
        np.testing.assert_array_equal(
            _np(getattr(T, fn)(_t(a), _t(b), tcfg, **kw)), want)


@pytest.mark.parametrize("name", ["posit8", "posit16"])
@pytest.mark.parametrize("mkn", [(16, 32, 8), (33, 65, 17)])
def test_gemm_matches_reference(name, mkn):
    """Two cases.  Small integers (every weight exact in the posit, every
    partial sum exact in f32): any summation order gives the same f32
    result, so the outputs must be equal.  Normal activations and
    quantized normal weights: the two matmuls add in different orders,
    so each output may differ by the f32 forward-error bound of both,
    2 K 2^-24 sum_k |a_ik w_kj| (the reference's rtol = atol = 1e-6 holds
    only between two XLA dots that share one order)."""
    rcfg, tcfg = CFGS[name]
    m, k, n = mkn
    rng = np.random.default_rng(m * k)
    for ints in (True, False):
        if ints:
            a = rng.integers(-4, 5, (m, k)).astype(np.float32)
            wf = rng.integers(-4, 5, (k, n)).astype(np.float32)
        else:
            a = rng.standard_normal((m, k)).astype(np.float32)
            wf = rng.standard_normal((k, n)).astype(np.float32)
        w = _np(T.quantize(_t(wf), tcfg))
        want = np.asarray(R.gemm(jnp.asarray(a), jnp.asarray(w), rcfg))
        got = T.gemm(_t(a), _t(w), tcfg).numpy()
        if ints:
            np.testing.assert_array_equal(got, want)
        else:
            wd = T.dequantize(_t(w), tcfg).numpy().astype(np.float64)
            bound = 2 * k * 2.0 ** -24 * (np.abs(a.astype(np.float64)) @ np.abs(wd))
            assert (np.abs(got.astype(np.float64) - want) <= bound).all()
    assert T.gemm(_t(a.reshape(1, m, k)), _t(w), tcfg).shape == (1, m, n)


def test_codec_ops_match_reference():
    rcfg, tcfg = CFGS["posit32"]
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((5, 33)) * np.exp(rng.uniform(-20, 20, (5, 33)))
         ).astype(np.float32)
    want = np.asarray(R.quantize(jnp.asarray(x), rcfg))
    got = T.quantize(_t(x), tcfg)
    np.testing.assert_array_equal(_np(got), want)
    back = np.asarray(R.dequantize(jnp.asarray(want), rcfg))
    np.testing.assert_array_equal(T.dequantize(got, tcfg).numpy().view(np.uint32),
                                  back.view(np.uint32))
