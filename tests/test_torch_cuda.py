"""On-card checks of the port's CUDA kernels against their plain versions.

Marked ``cuda``: they need an NVIDIA card, ``nvcc`` and the repo's
``csrc/`` sources, and skip elsewhere.  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The codec must be bit-exact; paged attention (dense/window and MLA)
agrees with its plain version within atol/rtol 1e-5 (both accumulate in
f32, in different orders).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.types import POSIT8, POSIT16
from repro_torch.kernels import posit_codec, posit_paged_attn as K
from repro_torch.models import layers as L

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("cfg", [POSIT16, POSIT8], ids=["posit16", "posit8"])
def test_codec_bit_exact_on_card(dev, cfg):
    pats = torch.arange(1 << cfg.nbits, dtype=torch.int64).to(cfg.storage_dtype)
    got = posit_codec.dequantize(pats.to(dev), cfg).cpu()
    ref = posit_codec.dequantize_plain(pats, cfg)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))

    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, 1 << 18, dtype=np.uint64).astype(np.uint32)
    x = torch.from_numpy(bits.view(np.float32).copy())
    got = posit_codec.quantize(x.to(dev), cfg).cpu()
    ref = posit_codec.quantize_plain(x, cfg)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("kv", [None, "posit16", "posit8"])
@pytest.mark.parametrize("window", [0, 24])
def test_paged_attention_matches_plain_on_card(dev, kv, window):
    rng = np.random.default_rng(1)
    b, g, r, d, bs = 4, 3, 4, 128, 16
    w = L.paged_window_blocks(window, bs) if window else 6
    nb = b * w
    tables = torch.arange(nb, dtype=torch.int32).reshape(b, w)
    tables[-1] = nb                                  # all-masked row
    tables[0, -1] = nb                               # sentinel tail
    lens = torch.tensor([70, 5, 93, 40], dtype=torch.int32)
    apos = L.paged_apos(tables, lens, bs, nb, window=window)
    shape = (nb, bs, g, d)
    k = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    pcfg = L.pcfg(kv) if kv else None
    if pcfg:
        k, v = posit_codec.quantize_plain(k, pcfg), posit_codec.quantize_plain(v, pcfg)
    q = torch.from_numpy(rng.normal(size=(b, g, r, d)).astype(np.float32))
    args = (q, k, v, tables, apos, lens)
    ref = K.paged_decode_attention_plain(*args, pcfg=pcfg, window=window)
    got = K.paged_decode_attention(*(t.to(dev) for t in args), pcfg=pcfg,
                                   window=window).cpu()
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    assert torch.all(got[-1] == 0)


@pytest.mark.parametrize("kv", [None, "bf16", "posit16", "posit8"])
def test_paged_attention_mla_matches_plain_on_card(dev, kv):
    """H 12 heads (a partial second head tile), rank 256, rope 32, block
    16; a sentinel tail and an all-masked row."""
    rng = np.random.default_rng(2)
    b, h, rank, rope, bs, w = 4, 12, 256, 32, 16, 6
    nb = b * w
    tables = torch.arange(nb, dtype=torch.int32).reshape(b, w)
    tables[-1] = nb                                  # all-masked row
    tables[0, -2:] = nb                              # sentinel tail
    lens = torch.tensor([60, 5, 93, 40], dtype=torch.int32)
    apos = L.paged_apos(tables, lens, bs, nb)
    c = torch.from_numpy(rng.normal(size=(nb, bs, rank)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(nb, bs, rope)).astype(np.float32))
    pcfg = L.pcfg(kv) if kv in ("posit16", "posit8") else None
    if pcfg:
        c, r = posit_codec.quantize_plain(c, pcfg), posit_codec.quantize_plain(r, pcfg)
    elif kv == "bf16":
        c, r = c.to(torch.bfloat16), r.to(torch.bfloat16)
    q_lat = torch.from_numpy(rng.normal(size=(b, h, rank)).astype(np.float32))
    q_rope = torch.from_numpy(rng.normal(size=(b, h, rope)).astype(np.float32))
    args = (q_lat, q_rope, c, r, tables, apos, lens)
    scale = 96 ** -0.5
    ref = K.paged_decode_attention_mla_plain(*args, pcfg=pcfg, scale=scale)
    got = K.paged_decode_attention_mla(*(t.to(dev) for t in args), pcfg=pcfg,
                                       scale=scale).cpu()
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    assert torch.all(got[-1] == 0)
