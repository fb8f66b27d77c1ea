"""The port's kernel modules against the JAX Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; the reference
kernels run in Pallas interpret mode, as the reference's own tests run
them.  The codec must be bit-exact; paged attention agrees within
atol = rtol = 1e-5 (both sides accumulate in f32, in different orders)
on the dense, sliding-window and MLA lanes, with f32, posit16 and posit8
KV, sentinel table entries, ring wraparound and an all-masked row, which
must be exact zeros on both sides.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import configs as RC
from repro.core.types import POSIT8 as R8, POSIT16 as R16
from repro.kernels import posit_codec as RK
from repro.kernels import posit_paged_attn as RPA
from repro_torch import configs as TC
from repro_torch.core.types import POSIT8, POSIT16
from repro_torch.kernels import posit_codec, posit_paged_attn as PA
from repro_torch.models import layers as L

FORMATS = [(R16, POSIT16), (R8, POSIT8)]
IDS = ["posit16", "posit8"]
ATOL = RTOL = 1e-5


@pytest.mark.parametrize("rcfg,tcfg", FORMATS, ids=IDS)
def test_dequantize_matches_dequantize_2d(rcfg, tcfg):
    n = 1 << tcfg.nbits
    pats = np.arange(n).astype(np.uint16 if n > 256 else np.uint8)
    pats = pats.reshape(-1, 256)
    ref = np.asarray(RK.dequantize_2d(jnp.asarray(pats), rcfg, interpret=True))
    got = posit_codec.dequantize(torch.from_numpy(pats), tcfg).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("rcfg,tcfg", FORMATS, ids=IDS)
def test_quantize_matches_quantize_2d(rcfg, tcfg):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((64, 128)) *
         np.exp2(rng.integers(-40, 40, (64, 128)))).astype(np.float32)
    x[0, :6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45]
    ref = np.asarray(RK.quantize_2d(jnp.asarray(x), rcfg, interpret=True))
    got = posit_codec.quantize(torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_array_equal(got, ref)


def _attn_case(kv, window, lens, seed):
    rng = np.random.default_rng(seed)
    g, r, d, bs = 2, 2, 16, 4
    b = len(lens)
    w = L.paged_window_blocks(window, bs) if window else 5
    nb = b * w
    tables = np.arange(nb, dtype=np.int32).reshape(b, w)
    tables[0, -1] = nb                       # unallocated tail: sentinel
    tables[-1, :] = nb                       # preempted row: all sentinels
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


@pytest.mark.parametrize("kv", [None, "posit16", "posit8"])
@pytest.mark.parametrize("window,lens", [(0, [9, 2, 17, 0]),
                                         (8, [13, 2, 22, 0])],
                         ids=["dense", "window-wrap"])
def test_paged_attention_matches_reference(kv, window, lens):
    """Window lens 13 and 22 wrap the 3-block ring; 2 does not."""
    q, k, v, tables, apos, lens = _attn_case(kv, window, lens, seed=5)
    rpcfg = {"posit16": R16, "posit8": R8}.get(kv)
    ref = np.asarray(RPA.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, k, v, tables, apos, lens)),
        pcfg=rpcfg, window=window, interpret=True))
    got = PA.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v, tables, apos, lens)),
        pcfg=L.pcfg(kv) if kv else None, window=window).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert (got[-1] == 0).all() and (ref[-1] == 0).all()


def _mla_case(kv, lens, seed):
    """MLA latent arenas at a small width: H 6 heads (not a multiple of
    the kernel's head tile), rank 16, rope 8, block 4, 5 table slots; a
    sentinel tail on row 0 and an all-sentinel last row."""
    rng = np.random.default_rng(seed)
    h, rank, rope, bs, w = 6, 16, 8, 4, 5
    b = len(lens)
    nb = b * w
    tables = np.arange(nb, dtype=np.int32).reshape(b, w)[:, ::-1].copy()
    tables[0, -2:] = nb
    tables[-1, :] = nb
    lens = np.asarray(lens, np.int32)
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


@pytest.mark.parametrize("kv", [None, "posit16", "posit8"])
def test_paged_attention_mla_matches_reference(kv):
    """Row 0's 11 positions end before its two sentinel tail blocks; the
    last row has no live block and must return exact zeros."""
    args = _mla_case(kv, [10, 3, 19, 0], seed=6)
    scale = (16 + 8) ** -0.5
    rpcfg = {"posit16": R16, "posit8": R8}.get(kv)
    ref = np.asarray(RPA.paged_decode_attention_mla(
        *(jnp.asarray(a) for a in args), pcfg=rpcfg, scale=scale,
        interpret=True))
    got = PA.paged_decode_attention_mla(
        *(torch.from_numpy(a) for a in args),
        pcfg=L.pcfg(kv) if kv else None, scale=scale).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert (got[-1] == 0).all() and (ref[-1] == 0).all()


def _check_kv_bytes(arch, kv):
    rc = dataclasses.replace(RC.get_config(arch), kv_posit=kv)
    tc = dataclasses.replace(TC.get_config(arch), kv_posit=kv)
    for kernel in ("fused", "gather"):
        assert PA.paged_decode_kv_bytes(tc, 64, 16, kernel) == \
            RPA.paged_decode_kv_bytes(rc, 64, 16, kernel)


@pytest.mark.parametrize("kv", [None, "posit16", "posit8"])
def test_paged_decode_kv_bytes_matches_reference(kv):
    _check_kv_bytes("phi3-medium-14b", kv)


@pytest.mark.parametrize("kv", [None, "posit16", "posit8"])
def test_paged_decode_kv_bytes_mla_matches_reference(kv):
    _check_kv_bytes("minicpm3-4b", kv)
