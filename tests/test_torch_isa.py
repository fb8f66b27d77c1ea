"""The port's PVU ISA (``repro_torch.core``) against the JAX reference.

Plain tensor versions only (the kernels' arithmetic is held to these
by ``tests/test_torch_csrc_host.py`` and, on the card,
``tests/test_torch_cuda.py``).  Every comparison is bit-exact on posit
patterns:

* vpadd / vpsub / vpmul / vpdiv (nr3 and exact) against
  ``repro.core.posit`` on every posit8 and posit8e0 pair, and on seeded
  2**16-pair sets with the edge patterns in posit16, posit16e1, posit32;
* vpdot (the streamable quire-lite) across the 4096 tile boundary, and
  the exact 512-bit quire, against ``repro.core.posit.vpdot``;
* ``bench_accuracy.py``'s 2 000 posit32 conv pairs (seed 42): the port's
  patterns are the reference's, so its accuracy table is the paper's;
* the golden model is a verbatim copy of the reference's.
"""
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import posit as RP
from repro.core import types as RT
from repro_torch.core import posit as TP
from repro_torch.core import types as TT

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Hundreds of small int64 ops per call: under the suite's parallel
    workers torch's intra-op threads only contend, so use one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CFGS = {"posit8": (RT.POSIT8, TT.POSIT8), "posit8e0": (RT.POSIT8_E0, TT.POSIT8_E0),
        "posit16": (RT.POSIT16, TT.POSIT16),
        "posit16e1": (RT.POSIT16_E1, TT.POSIT16_E1),
        "posit32": (RT.POSIT32, TT.POSIT32)}
NP = {8: np.uint8, 16: np.uint16, 32: np.uint32}


def _edges(cfg):
    return np.array([0, cfg.nar_pattern, cfg.maxpos_pattern, 1,
                     (-1) & cfg.mask, (-cfg.maxpos_pattern) & cfg.mask],
                    np.uint64)


def _pairs(cfg, seed=0):
    """Every pair for 8-bit configs; else the edge patterns crossed with
    each other plus 2**16 seeded pairs."""
    dt = NP[cfg.nbits]
    if cfg.nbits == 8:
        p = np.arange(256)
        a, b = np.meshgrid(p, p, indexing="ij")
        return a.ravel().astype(dt), b.ravel().astype(dt)
    rng = np.random.default_rng(seed)
    ea, eb = np.meshgrid(_edges(cfg), _edges(cfg), indexing="ij")
    a = rng.integers(0, 2 ** cfg.nbits, 1 << 16, dtype=np.uint64)
    b = rng.integers(0, 2 ** cfg.nbits, 1 << 16, dtype=np.uint64)
    return (np.concatenate([ea.ravel(), a]).astype(dt),
            np.concatenate([eb.ravel(), b]).astype(dt))


def _ref(fn, a, b, cfg, **kw):
    """The reference op, jitted whole (eager dispatch compiles every
    primitive separately and is far slower at these sizes)."""
    return np.asarray(jax.jit(lambda x, y: fn(x, y, cfg, **kw))(
        jnp.asarray(a), jnp.asarray(b)))


def _port(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _np(t, cfg):
    return TT.signed_view(t).numpy().view(NP[cfg.nbits])


_OPS = {
    "add": (RP.vpadd, TP.vpadd, {}),
    "sub": (RP.vpsub, TP.vpsub, {}),
    "mul": (RP.vpmul, TP.vpmul, {}),
    "div_nr3": (RP.vpdiv, TP.vpdiv, {"mode": "nr3"}),
    "div_exact": (RP.vpdiv, TP.vpdiv, {"mode": "exact"}),
}


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("op", sorted(_OPS))
def test_elementwise_isa_matches_reference(name, op):
    rcfg, tcfg = CFGS[name]
    a, b = _pairs(rcfg)
    rf, tf, kw = _OPS[op]
    want = _ref(rf, a, b, rcfg, **kw)
    got = tf(_port(a), _port(b), tcfg, **kw)
    assert got.dtype == tcfg.storage_dtype
    bad = np.nonzero(_np(got, tcfg) != want)[0][:5]
    assert bad.size == 0, [(int(a[i]), int(b[i])) for i in bad]


def _dot_rows(cfg, length, seed):
    """Random patterns (NaR only where placed), a zero row and a
    bounded-spread row."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** cfg.nbits, (4, length), dtype=np.uint64)
    b = rng.integers(0, 2 ** cfg.nbits, (4, length), dtype=np.uint64)
    a[a == cfg.nar_pattern] = 1
    b[b == cfg.nar_pattern] = 1
    a[1] = 0
    x = rng.uniform(1, 2, length) * rng.choice([-1.0, 1.0], length)
    a[2] = TP.f32_to_posit(torch.from_numpy(x.astype(np.float32)),
                           TT.PositConfig(cfg.nbits, cfg.es)).to(torch.int64) \
        .numpy().astype(np.uint64) & cfg.mask
    a[3, -1] = cfg.nar_pattern
    return a.astype(NP[cfg.nbits]), b.astype(NP[cfg.nbits])


@pytest.mark.parametrize("length", [1, 16, 33, 4095, 4096, 4097])
def test_vpdot_matches_reference_across_tiles(length):
    for name in ("posit16", "posit32"):
        rcfg, tcfg = CFGS[name]
        a, b = _dot_rows(rcfg, length, seed=length)
        want = _ref(RP.vpdot, a, b, rcfg)
        got = TP.vpdot(_port(a), _port(b), tcfg)
        np.testing.assert_array_equal(_np(got, tcfg), want, err_msg=name)


@pytest.mark.parametrize("length", [33, 4097])
def test_vpdot_exact_quire_matches_reference(length):
    rcfg, tcfg = CFGS["posit32"]
    a, b = _dot_rows(rcfg, length, seed=7)
    want = _ref(RP.vpdot, a, b, rcfg, mode="quire")
    got = TP.vpdot(_port(a), _port(b), tcfg, mode="quire")
    np.testing.assert_array_equal(_np(got, tcfg), want)


def test_vpdot_over_a_middle_axis_and_vpneg():
    rcfg, tcfg = CFGS["posit16"]
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2 ** 16, (3, 20, 5), dtype=np.uint64).astype(np.uint16)
    b = rng.integers(0, 2 ** 16, (3, 20, 5), dtype=np.uint64).astype(np.uint16)
    want = _ref(RP.vpdot, a, b, rcfg, axis=1)
    np.testing.assert_array_equal(
        _np(TP.vpdot(_port(a), _port(b), tcfg, dim=1), tcfg), want)
    np.testing.assert_array_equal(
        _np(TP.vpneg(_port(a), tcfg), tcfg),
        np.asarray(RP.vpneg(jnp.asarray(a), rcfg)))


def _bench_accuracy_pairs():
    """``benchmarks/bench_accuracy.py``'s data: 2 000 int8-style conv
    (activation, weight) pairs, seed 42, rounded to posit32 by the
    golden model."""
    from repro.core import softposit_ref as ref
    rng = np.random.default_rng(42)
    acts = rng.integers(0, 128, size=2000) * 0.02
    wts = rng.integers(-127, 128, size=2000) * 0.005
    wts[wts == 0] = 0.005
    a = np.array([ref.from_float(float(v), RT.POSIT32) for v in acts], np.uint32)
    b = np.array([ref.from_float(float(v), RT.POSIT32) for v in wts], np.uint32)
    return a, b


def test_conv_pairs_equal_reference_patterns():
    """Every op of the paper's accuracy table on the 2 000 conv pairs,
    and vpdot on 125 windows of 16: the port's patterns are the
    reference's, so its exact-match rates are too."""
    rcfg, tcfg = CFGS["posit32"]
    a, b = _bench_accuracy_pairs()
    for op, (rf, tf, kw) in _OPS.items():
        want = _ref(rf, a, b, rcfg, **kw)
        np.testing.assert_array_equal(_np(tf(_port(a), _port(b), tcfg, **kw),
                                          tcfg), want, err_msg=op)
    a2, b2 = a.reshape(125, 16), b.reshape(125, 16)
    want = _ref(RP.vpdot, a2, b2, rcfg)
    np.testing.assert_array_equal(_np(TP.vpdot(_port(a2), _port(b2), tcfg),
                                      tcfg), want)


def test_golden_model_is_the_references_copy():
    """``core/softposit_ref.py`` is a verbatim copy (its only import is
    relative, so it binds the port's ``PositConfig``), and the copy
    answers like the original."""
    from repro.core import softposit_ref as R
    from repro_torch.core import softposit_ref as T
    src = ROOT / "src" / "repro" / "core" / "softposit_ref.py"
    dst = ROOT / "src" / "repro_torch" / "core" / "softposit_ref.py"
    assert dst.read_text() == src.read_text()
    for x, y in [(3, 100), (0x40, 0x7F), (1, 1), (0x80, 5)]:
        for fn in ("add", "sub", "mul", "div"):
            assert getattr(T, fn)(x, y, TT.POSIT8) == \
                getattr(R, fn)(x, y, RT.POSIT8)
    assert T.from_float(0.1, TT.POSIT32) == R.from_float(0.1, RT.POSIT32)


def test_posit_matmul_decodes_then_multiplies():
    rcfg, tcfg = CFGS["posit16"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 12)).astype(np.float32)
    w = rng.integers(0, 2 ** 16, (12, 7), dtype=np.uint64).astype(np.uint16)
    w[w == rcfg.nar_pattern] = 0
    want = np.asarray(RP.posit_matmul(jnp.asarray(x), jnp.asarray(w), rcfg))
    got = TP.posit_matmul(torch.from_numpy(x), _port(w), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
