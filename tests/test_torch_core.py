"""The port's posit codec (``repro_torch.core.convert``) against the JAX
reference (``repro.core.convert``): bit-exact, both directions.

Decode covers every posit16 and posit8 pattern; encode covers +/-0,
subnormals, +/-Inf and NaN (-> NaR), the exact midpoints between
adjacent posits (round-to-nearest-even ties) and a seeded sweep of
2**16 f32 bit patterns across the whole exponent range.  posit32 (a
seeded pattern sample) and the es variants posit16e1 and posit8e0
(every pattern) get the same decode and encode checks.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import convert as RC
from repro.core.types import POSIT8 as R8, POSIT16 as R16
from repro.core.types import POSIT8_E0 as R8E0, POSIT16_E1 as R16E1, POSIT32 as R32
from repro_torch.core import convert as TC
from repro_torch.core.types import (POSIT8, POSIT8_E0, POSIT16, POSIT16_E1,
                                    POSIT32, signed_view)

FORMATS = [(R16, POSIT16), (R8, POSIT8)]
IDS = ["posit16", "posit8"]


def _all_patterns(cfg):
    return np.arange(1 << cfg.nbits).astype(
        np.uint16 if cfg.nbits == 16 else np.uint8)


def _ref_encode(x, rcfg):
    return np.asarray(RC.f32_to_posit(jnp.asarray(x), rcfg))


def _port_encode(x, tcfg):
    return TC.f32_to_posit(torch.from_numpy(np.asarray(x, np.float32)),
                           tcfg).numpy()


@pytest.mark.parametrize("rcfg,tcfg", FORMATS, ids=IDS)
def test_posit_to_f32_all_patterns(rcfg, tcfg):
    pats = _all_patterns(rcfg)
    ref = np.asarray(RC.posit_to_f32(jnp.asarray(pats), rcfg)).view(np.uint32)
    got = TC.posit_to_f32(torch.from_numpy(pats), tcfg).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("rcfg,tcfg", FORMATS, ids=IDS)
def test_f32_to_posit_specials(rcfg, tcfg):
    x = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                  1e-45, -1e-45, 1e-40, -3e-39, 1.1754942e-38,
                  3.4028235e38, -3.4028235e38, 1.0, -1.0], np.float32)
    got = _port_encode(x, tcfg)
    np.testing.assert_array_equal(got, _ref_encode(x, rcfg))
    assert got.dtype == (np.uint16 if tcfg.nbits == 16 else np.uint8)
    assert got[0] == got[1] == 0
    assert (got[2:6] == tcfg.nar_pattern).all()


@pytest.mark.parametrize("rcfg,tcfg", FORMATS, ids=IDS)
def test_f32_to_posit_rne_ties(rcfg, tcfg):
    """Exact midpoints between adjacent finite posits (and their
    neighbours one f32 ulp away) round to nearest even like the
    reference."""
    vals = np.asarray(RC.posit_to_f32(jnp.asarray(_all_patterns(rcfg)), rcfg),
                      np.float64)
    fs = np.unique(vals[np.isfinite(vals)])
    mid = ((fs[1:] + fs[:-1]) / 2).astype(np.float32)
    x = np.concatenate([mid, np.nextafter(mid, np.float32(np.inf)),
                        np.nextafter(mid, np.float32(-np.inf))])
    np.testing.assert_array_equal(_port_encode(x, tcfg), _ref_encode(x, rcfg))


@pytest.mark.parametrize("rcfg,tcfg", FORMATS, ids=IDS)
def test_f32_to_posit_seeded_sweep(rcfg, tcfg):
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2**32, 1 << 16, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32)
    np.testing.assert_array_equal(_port_encode(x, tcfg), _ref_encode(x, rcfg))


# posit32 and the es variants (the codec configs of the ISA's kernels)

WIDE = [(R32, POSIT32), (R16E1, POSIT16_E1), (R8E0, POSIT8_E0)]
WIDE_IDS = ["posit32", "posit16e1", "posit8e0"]


def _patterns_sample(cfg, seed=12):
    """Every pattern below 32 bits; for posit32 a seeded 2**16 sample
    plus zero, NaR, +-minpos and +-maxpos."""
    if cfg.nbits < 32:
        return _all_patterns(cfg)
    rng = np.random.default_rng(seed)
    edges = np.array([0, cfg.nar_pattern, 1, cfg.mask, cfg.maxpos_pattern,
                      cfg.nar_pattern + 1], np.uint64)
    pats = rng.integers(0, 2 ** 32, 1 << 16, dtype=np.uint64)
    return np.concatenate([edges, pats]).astype(np.uint32)


@pytest.mark.parametrize("rcfg,tcfg", WIDE, ids=WIDE_IDS)
def test_posit_to_f32_wide_and_es_variants(rcfg, tcfg):
    pats = _patterns_sample(rcfg)
    ref = np.asarray(RC.posit_to_f32(jnp.asarray(pats), rcfg)).view(np.uint32)
    got = TC.posit_to_f32(torch.from_numpy(pats), tcfg).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("rcfg,tcfg", WIDE, ids=WIDE_IDS)
def test_f32_to_posit_wide_and_es_variants(rcfg, tcfg):
    """Specials, a seeded sweep of 2**16 f32 bit patterns, and the f32
    values the patterns decode to, encoded again."""
    rng = np.random.default_rng(13)
    bits = rng.integers(0, 2**32, 1 << 16, dtype=np.uint64).astype(np.uint32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -3e-39,
                         1.0, -1.0, 0.02, 3.4028235e38], np.float32)
    x = np.concatenate([bits.view(np.float32), specials])
    got = TC.f32_to_posit(torch.from_numpy(x), tcfg)
    assert got.dtype == tcfg.storage_dtype
    want = np.asarray(RC.f32_to_posit(jnp.asarray(x), rcfg))
    np.testing.assert_array_equal(
        signed_view(got).numpy().view(want.dtype), want)
    vals = np.asarray(RC.posit_to_f32(jnp.asarray(_patterns_sample(rcfg)), rcfg))
    vals = vals[np.isfinite(vals)]
    np.testing.assert_array_equal(
        signed_view(TC.f32_to_posit(torch.from_numpy(vals), tcfg)).numpy()
        .view(want.dtype), np.asarray(RC.f32_to_posit(jnp.asarray(vals), rcfg)))


def test_quant_dequant_posit32():
    rng = np.random.default_rng(14)
    x = (rng.standard_normal(4096) * np.exp(rng.uniform(-30, 30, 4096))
         ).astype(np.float32)
    got = TC.quant_dequant(torch.from_numpy(x), POSIT32).numpy()
    want = np.asarray(RC.quant_dequant(jnp.asarray(x), R32))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("rcfg,tcfg", [(R32, POSIT32), (R16, POSIT16), (R8, POSIT8),
                                       (R16E1, POSIT16_E1), (R8E0, POSIT8_E0)],
                         ids=["posit32", "posit16", "posit8", "posit16e1", "posit8e0"])
def test_posit_config_constants_match_reference(rcfg, tcfg):
    """Every derived constant of ``PositConfig`` (``useed`` and
    ``max_frac_bits`` included) equals the reference's on the five
    configs."""
    for name in ("useed", "mask", "nar_pattern", "maxpos_pattern",
                 "minpos_pattern", "max_scale", "min_scale", "max_frac_bits",
                 "name"):
        assert getattr(tcfg, name) == getattr(rcfg, name), name
    assert (tcfg.nbits, tcfg.es, tcfg.align_width) == \
        (rcfg.nbits, rcfg.es, rcfg.align_width)
