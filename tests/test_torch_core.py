"""The port's posit codec (``repro_torch.core.convert``) against the JAX
reference (``repro.core.convert``): bit-exact, both directions.

Decode covers every posit16 and posit8 pattern; encode covers +/-0,
subnormals, +/-Inf and NaN (-> NaR), the exact midpoints between
adjacent posits (round-to-nearest-even ties) and a seeded sweep of
2**16 f32 bit patterns across the whole exponent range.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import convert as RC
from repro.core.types import POSIT8 as R8, POSIT16 as R16
from repro_torch.core import convert as TC
from repro_torch.core.types import POSIT8, POSIT16

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
