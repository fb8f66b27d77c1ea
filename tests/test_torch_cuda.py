"""On-card checks of the port's CUDA kernels against their plain versions.

Marked ``cuda``: they need an NVIDIA card, ``nvcc`` and the repo's
``csrc/`` sources, and skip elsewhere.  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The codec, the fused quantize-and-write into the paged arena, the
fused chunked-prefill read out of it and the PVU ISA kernels (elementwise ops, the quire dot, pgemm) must be
bit-exact; paged attention (dense/window and MLA) agrees
with its plain version within atol/rtol 1e-5 (both accumulate in f32,
in different orders), and the posit-weight gemm within the f32
forward-error bound of two summation orders.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.types import CONFIGS, POSIT8, POSIT16, POSIT32, signed_view
from repro_torch.kernels import ops, posit_codec, posit_paged_attn as K
from repro_torch.kernels import posit_dot, posit_ew, posit_gemm, posit_qgemm
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


def _split_case(kv, d, bs, window, r, g=3):
    """Paged attention inputs that cross several splits: W = 7 table
    entries dense (3 or 7 in the window ring), a sentinel tail on row 0,
    on row 1 (dense) a hole of sentinel entries 3..5 with live blocks
    after it, and an all-masked last row; ``g`` KV heads of ``r`` query
    heads each."""
    rng = np.random.default_rng(d + bs + window + r)
    b = 4
    w = L.paged_window_blocks(window, bs) if window else 7
    nb = b * w
    tables = torch.from_numpy(rng.permutation(nb).astype(np.int32)).reshape(b, w)
    tables[-1] = nb                                  # all-masked row
    tables[0, -1] = nb                               # sentinel tail
    cap = w * bs
    if window:
        lens = [window + 7, 5, 3 * window + 1, window - 1]
    else:
        tables[1, 3:6] = nb                          # a sentinel-only run
        lens = [cap - bs - 3, cap - 2, cap - 1, 0]
    lens = torch.tensor(lens, dtype=torch.int32)
    apos = L.paged_apos(tables, lens, bs, nb, window=window)
    shape = (nb, bs, g, d)
    k = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    pcfg = L.pcfg(kv) if kv in ("posit16", "posit8") else None
    if pcfg:
        k, v = posit_codec.quantize_plain(k, pcfg), posit_codec.quantize_plain(v, pcfg)
    elif kv == "bf16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    q = torch.from_numpy((rng.normal(size=(b, g, r, d)) * d ** -0.5).astype(np.float32))
    return (q, k, v, tables, apos, lens), pcfg


@pytest.mark.parametrize("kv", [None, "bf16", "posit16", "posit8"])
@pytest.mark.parametrize("d,bs,r", [(16, 4, 5), (128, 16, 4)],
                         ids=["d16-bs4-r5", "d128-bs16-r4"])
@pytest.mark.parametrize("window", [0, 24], ids=["dense", "window"])
@pytest.mark.parametrize("chunk", [None, 1, 3], ids=["auto", "c1", "c3"])
def test_paged_attention_splits_match_plain_on_card(dev, kv, d, bs, r, window,
                                                    chunk):
    """Several splits per row (W 7 is no multiple of 3), a split made
    only of sentinels, the all-masked row, the window ring, two head
    counts (one and two heads per warp), and the wrapper's own split."""
    args, pcfg = _split_case(kv, d, bs, window, r)
    ref = K.paged_decode_attention_plain(*args, pcfg=pcfg, window=window)
    on = [t.to(dev) for t in args]
    if chunk is None:
        got = K.paged_decode_attention(*on, pcfg=pcfg, window=window)
    else:
        call, got = K.paged_decode_attention_call(*on, pcfg=pcfg, window=window,
                                                  chunk=chunk)
        assert call() == 0
    got = got.cpu()
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    assert torch.all(got[-1] == 0)


@pytest.mark.parametrize("kv", ["posit16", "posit8", None])
@pytest.mark.parametrize("d", [16, 20], ids=["d16", "d20-ragged"])
def test_paged_attention_scalar_edge_path_on_card(dev, kv, d):
    """Arena bases one element off 16 bytes, and a ragged D (20: rows
    of 40 or 20 bytes), take the kernel's scalar copy path."""
    args, pcfg = _split_case(kv, d, 4, 0, 4)
    ref = K.paged_decode_attention_plain(*args, pcfg=pcfg)
    q, k, v, tables, apos, lens = args
    shifted = []
    for t in (k, v):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        flat[1:] = t.reshape(-1).to(dev)
        shifted.append(flat[1:].view(t.shape))
    got = K.paged_decode_attention(q.to(dev), *shifted, tables.to(dev),
                                   apos.to(dev), lens.to(dev), pcfg=pcfg).cpu()
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    assert torch.all(got[-1] == 0)


def test_paged_attention_is_deterministic_on_card(dev):
    args, pcfg = _split_case("posit16", 128, 16, 0, 4)
    on = [t.to(dev) for t in args]
    a = K.paged_decode_attention(*on, pcfg=pcfg)
    b = K.paged_decode_attention(*on, pcfg=pcfg)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("kv", [None, "posit16", "posit8"])
@pytest.mark.parametrize("d,bs,r", [(16, 4, 5), (128, 16, 4)],
                         ids=["d16-bs4-r5", "d128-bs16-r4"])
@pytest.mark.parametrize("window", [0, 24], ids=["dense", "window"])
@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_paged_attention_fold_matches_plain_fold_on_card(dev, kv, d, bs, r,
                                                         window, chunk):
    """The kernel's split-and-fold against the fold's plain version on
    the plain walk of each run's sub-table (every other entry the
    sentinel): empty runs (the hole, the all-masked row) weigh nothing,
    and the all-masked row is exact zeros."""
    args, pcfg = _split_case(kv, d, bs, window, r)
    q, k, v, tables, apos, lens = args
    nb, w = k.shape[0], tables.shape[1]
    ms, ls, accs = [], [], []
    for w0 in range(0, w, chunk):
        sub = torch.full_like(tables, nb)
        sub[:, w0:w0 + chunk] = tables[:, w0:w0 + chunk]
        m, l, acc = K.paged_decode_partial_plain(q, k, v, sub, apos, lens,
                                                 pcfg=pcfg, window=window)
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    want = K.fold_partials_plain(torch.stack(ms, -1), torch.stack(ls, -1),
                                 torch.stack(accs, -2))
    call, got = K.paged_decode_attention_call(*(t.to(dev) for t in args),
                                              pcfg=pcfg, window=window,
                                              chunk=chunk)
    assert call() == 0
    got = got.cpu()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.all(got[-1] == 0)


def _mla_case(kv, b, h, w, layout="permuted"):
    """MLA decode inputs, rank 256, rope 32, block 16, a sentinel tail on
    row 0 and an all-masked last row.  ``permuted``: permuted tables,
    ragged lens, sentinel entries 2..3 of row 1 (W > 4) with live blocks
    after them.  ``identity``: identity tables and lens [60, 5, 93, 40]
    (B 4, W 6), so the all-masked row's lens names 40 live tokens."""
    rank, rope, bs = 256, 32, 16
    nb = b * w
    if layout == "identity":
        rng = np.random.default_rng(2)
        tables = torch.arange(nb, dtype=torch.int32).reshape(b, w)
        lens = [60, 5, 93, 40]
    else:
        rng = np.random.default_rng(h + w)
        tables = torch.from_numpy(rng.permutation(nb).astype(np.int32)).reshape(b, w)
        if w > 4:
            tables[1, 2:4] = nb                      # a hole mid-table
        cap = w * bs
        lens = [cap - 2 * bs - 4, cap - 1, cap // 2, cap // 3, cap - 7, 5, cap - 20, 0][-b:]
    tables[-1] = nb                                  # all-masked row
    tables[0, -2:] = nb                              # sentinel tail
    lens = torch.tensor(lens, dtype=torch.int32)
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
    return (q_lat, q_rope, c, r, tables, apos, lens), pcfg


@pytest.mark.parametrize("kv", [None, "bf16", "posit16", "posit8"])
@pytest.mark.parametrize("b,h,w,layout", [(4, 12, 6, "identity"), (4, 12, 6, "permuted"),
                                          (8, 40, 64, "permuted"), (8, 20, 64, "permuted")],
                         ids=["h12-w6-identity", "h12-w6", "minicpm3-h40-w64",
                              "minicpm3-mp2-h20-w64"])
@pytest.mark.parametrize("chunk", [None, 1, 3], ids=["auto", "c1", "c3"])
def test_paged_attention_mla_matches_plain_on_card(dev, kv, b, h, w, layout, chunk):
    """H 12 (a partial last head group), minicpm3-4b's H 40 at W 64 and a
    rank's 20 of them under tensor parallelism at mp 2;
    the wrapper's own split and forced ones (a split per entry, and runs
    of 3, no divisor of W); a sentinel tail, a hole and an all-masked row
    (see :func:`_mla_case`)."""
    args, pcfg = _mla_case(kv, b, h, w, layout)
    scale = 96 ** -0.5
    ref = K.paged_decode_attention_mla_plain(*args, pcfg=pcfg, scale=scale)
    on = [t.to(dev) for t in args]
    if chunk is None:
        got = K.paged_decode_attention_mla(*on, pcfg=pcfg, scale=scale)
    else:
        call, got = K.paged_decode_attention_mla_call(*on, pcfg=pcfg, scale=scale,
                                                      chunk=chunk)
        assert call() == 0
    got = got.cpu()
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    assert torch.all(got[-1] == 0)


def test_paged_attention_mla_is_deterministic_on_card(dev):
    args, pcfg = _mla_case("posit16", 8, 40, 64)
    on = [t.to(dev) for t in args]
    a = K.paged_decode_attention_mla(*on, pcfg=pcfg, scale=0.1)
    b = K.paged_decode_attention_mla(*on, pcfg=pcfg, scale=0.1)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("cfg", [POSIT16, POSIT8], ids=["posit16", "posit8"])
@pytest.mark.parametrize("src", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 8], ids=["dense", "window"])
def test_paged_write_matches_quantize_and_scatter_on_card(dev, cfg, src, window):
    """The fused quantize-and-write leaves the arenas (a K/V pair and an
    MLA pair of widths) bit-identical to ``quantize_plain`` + the masked
    scatter, for a decode token (an inactive row, a write through a
    sentinel entry, a row past the table) and a prefill chunk."""
    rng = np.random.default_rng(window + cfg.nbits)
    b, bs, nb, c = 5, 4, 40, 6
    w = L.paged_window_blocks(window, bs) if window else 6
    tables = torch.from_numpy(rng.permutation(nb)[:b * w].astype(np.int32)).reshape(b, w)
    pos = torch.tensor([3, 9, 13, 23, 30 if window else 24])
    tables[1, (9 // bs) % w] = nb                    # row 1: through a sentinel
    ok = torch.tensor([True, True, False, True, True])
    n_valid = torch.tensor([6, 2, 0, 6, 1])
    for feats in (((2, 16), (2, 16)), ((24,), (8,))):
        leaves = [posit_codec.quantize_plain(torch.from_numpy(
            rng.normal(size=(2, nb, bs) + f).astype(np.float32)), cfg) for f in feats]
        one = [torch.from_numpy(rng.normal(size=(b,) + f).astype(np.float32)).to(src)
               for f in feats]
        chunk = [torch.from_numpy(rng.normal(size=(2, b, c) + f).astype(np.float32)).to(src)
                 for f in feats]
        geo = dict(n_blocks=nb, block_size=bs, window=window)
        want = [a.clone() for a in leaves]
        index = L.paged_write_index(tables, pos, ok, **geo)
        for a, x in zip(want, one):
            L.paged_write(a[0], posit_codec.quantize_plain(x.float(), cfg), index)
        for a, x in zip(want, chunk):
            L.paged_pack_range(a, posit_codec.quantize_plain(x.float(), cfg), tables,
                               pos, pos + n_valid, window=window)
        got = [a.to(dev) for a in leaves]
        slots = L.paged_write_slots(tables, pos, ok, **geo).to(dev)
        posit_codec.paged_write([(a[0], x.to(dev)) for a, x in zip(got, one)], slots, cfg)
        slots = L.paged_pack_slots(tables, pos, pos + n_valid, c, **geo).reshape(-1).to(dev)
        for a, x in zip(got, chunk):
            posit_codec.paged_write([(a[li], x[li].reshape((-1,) + x.shape[3:]).to(dev))
                                     for li in range(2)], slots, cfg)
        for g, x in zip(got, want):
            assert torch.equal(signed_view(g.cpu()), signed_view(x))


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_quantize_misaligned_views_on_card(dev, cfg):
    """The quantize on contiguous views at element offsets 1-7 of their
    buffers (a ragged head, a source not aligned with the output's 16-byte
    vectors), lengths below one vector, at one and past one CTA's chunk."""
    rng = np.random.default_rng(cfg.nbits + cfg.es)
    for n in (1, 7, 16, 17, 1531, 100_003):
        bits = rng.integers(0, 2**32, n + 8, dtype=np.uint64).astype(np.uint32)
        x = torch.from_numpy(bits.view(np.float32).copy())
        x[::3] = torch.from_numpy(rng.standard_normal(x[::3].numel()).astype(np.float32))
        for off in range(8):
            xv = x.to(dev)[off:off + n]
            got = posit_codec.quantize(xv, cfg)
            assert _eq(got, posit_codec.quantize_plain(xv.cpu(), cfg)), (n, off)
            call, out = posit_codec.quantize_call(xv, cfg)
            assert call() == 0
            assert _eq(out, posit_codec.quantize_plain(xv.cpu(), cfg))


@pytest.mark.parametrize("shape,cfg", [((17920, 5120), POSIT16), ((8, 3, 224, 224), POSIT32),
                                       ((64,), POSIT32), ((16, 17920), POSIT16)],
                         ids=["p3-weight", "p2-images", "p2-bias", "p3-activations"])
def test_quantize_at_phase_shapes_on_card(dev, shape, cfg):
    """The quantize at the shapes the ISA phases launch it (P3's 91.75 M
    weight, P2's images and bias), N(0, 1) values and a spread of
    exponents, against the plain version on the card."""
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, device=dev)
    x = x * torch.exp2(torch.randint(-20, 20, shape, generator=gen, device=dev).float())
    assert _eq(posit_codec.quantize(x, cfg), posit_codec.quantize_plain(x, cfg).cpu())


@pytest.mark.parametrize("cfg", [POSIT16, POSIT8], ids=["posit16", "posit8"])
@pytest.mark.parametrize("src", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_paged_write_main_path_shapes_and_views_on_card(dev, cfg, src):
    """The fused write at the main path's shapes (a decode step's K and V,
    8 rows x 10 x 128; MLA's 256 and 32; a prefill leaf of 40 layers x 128
    rows x 1 280), at 32 and 64 jobs of 16 rows (2 and 4 rows a CTA), with
    dropped rows, and on arenas and sources that are views at odd element
    offsets with a width of 20 (no whole vectors), against
    ``paged_write_plain``."""
    rng = np.random.default_rng(cfg.nbits)
    gen = torch.Generator(device=dev).manual_seed(5)

    def leaf(n_layers, nb, bs, feat, off=0):
        n = n_layers * nb * bs * int(np.prod(feat))
        half = 1 << (cfg.nbits - 1)
        flat = torch.randint(-half, half, (n + off,), generator=gen, device=dev,
                             dtype={16: torch.int16, 8: torch.int8}[cfg.nbits])
        return flat.view(cfg.storage_dtype)[off:].view((n_layers, nb, bs) + feat)

    def check(jobs, slots):
        want = [(a.clone(), x) for a, x in jobs]
        posit_codec.paged_write_plain(want, slots, cfg)
        posit_codec.paged_write(jobs, slots, cfg)
        for (g, _), (w, _) in zip(jobs, want):
            assert torch.equal(signed_view(g), signed_view(w))

    nb, bs = 64, 16
    slots = torch.from_numpy(rng.permutation(nb * bs)[:8].astype(np.int64)).to(dev)
    slots[3], slots[5] = -1, nb * bs
    for feats in (((10, 128), (10, 128)), ((256,), (32,))):
        arenas = [leaf(1, nb, bs, f) for f in feats]
        check([(a[0], torch.randn((8,) + f, generator=gen, device=dev).to(src))
               for a, f in zip(arenas, feats)], slots)
    pslots = torch.from_numpy(rng.permutation(nb * bs)[:128].astype(np.int64)).to(dev)
    pslots[::7] = -1
    arena = leaf(40, nb, bs, (10, 128))
    chunk = torch.randn((40, 128, 10, 128), generator=gen, device=dev).to(src)
    check([(arena[li], chunk[li]) for li in range(40)], pslots)
    for n_jobs in (32, 64):                          # 2 and 4 rows a CTA
        arena = leaf(n_jobs, nb, bs, (10, 128))
        chunk = torch.randn((n_jobs, 16, 10, 128), generator=gen, device=dev).to(src)
        check([(arena[li], chunk[li]) for li in range(n_jobs)], pslots[:16])
    for a_off, s_off in ((1, 0), (0, 3), (5, 1)):
        arenas = [leaf(1, nb, bs, (20,), a_off) for _ in range(2)]
        xs = [torch.randn(8 * 20 + s_off, generator=gen, device=dev).to(src)[s_off:].view(8, 20)
              for _ in range(2)]
        check([(a[0], x) for a, x in zip(arenas, xs)], slots)


@pytest.mark.parametrize("cfg", [POSIT16, POSIT8], ids=["posit16", "posit8"])
@pytest.mark.parametrize("src", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("t,pos,ring", [(1024, 700, False), (48, 1000, True),
                                        (1024, 1024, False)],
                         ids=["linear", "ring", "dropped"])
def test_linear_decode_write_matches_plain_on_card(dev, cfg, src, t, pos, ring):
    """The fused write as the linear decode lanes launch it: one layer's
    two leaves (8, T, 10, 128), each an arena of 8 blocks of T slots,
    rows written at the frontier (``pos % T`` on a 48-slot ring past a
    wrap; at ``pos >= T`` on a linear leaf every write drops and the
    leaves stay unchanged), against ``paged_write_plain``."""
    gen = torch.Generator(device=dev).manual_seed(11)
    half = 1 << (cfg.nbits - 1)
    signed = {16: torch.int16, 8: torch.int8}[cfg.nbits]
    leaves = [torch.randint(-half, half, (8, t, 10, 128), generator=gen, device=dev,
                            dtype=signed).view(cfg.storage_dtype) for _ in range(2)]
    rows = [torch.randn((8, 10, 128), generator=gen, device=dev).to(src) for _ in range(2)]
    slots = L.linear_write_slots(8, t, pos, ring=ring, device=dev)
    want = [(a.clone(), x) for a, x in zip(leaves, rows)]
    got = [(a.clone(), x) for a, x in zip(leaves, rows)]
    posit_codec.paged_write_plain(want, slots, cfg)
    posit_codec.paged_write(got, slots, cfg)
    for (g, _), (w, _), a in zip(got, want, leaves):
        assert torch.equal(signed_view(g), signed_view(w))
        assert torch.equal(signed_view(g), signed_view(a)) == (pos >= t and not ring)


@pytest.mark.parametrize("shape", [(8, 1024, 10, 128), (8, 1024, 256), (8, 1024, 32)],
                         ids=["phi3", "mla-latent", "mla-rope"])
@pytest.mark.parametrize("cfg", [POSIT16, POSIT8], ids=["posit16", "posit8"])
def test_dequantize_at_linear_decode_shapes_on_card(dev, cfg, shape):
    """The codec's dequantize of one layer's whole linear cache leaf, as
    every linear decode step launches it, on random patterns (NaR
    included), bit for bit against ``dequantize_plain``."""
    gen = torch.Generator(device=dev).manual_seed(12)
    half = 1 << (cfg.nbits - 1)
    pats = torch.randint(-half, half, shape, generator=gen, device=dev,
                         dtype={16: torch.int16, 8: torch.int8}[cfg.nbits]
                         ).view(cfg.storage_dtype)
    got = posit_codec.dequantize(pats, cfg).cpu()
    want = posit_codec.dequantize_plain(pats.cpu(), cfg)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _leaves_on_card(dev, cfg, shapes, seed):
    """Random patterns of every bit, NaR at each non-empty leaf's head, on
    the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    half = 1 << (cfg.nbits - 1)
    out = []
    for shape in shapes:
        p = torch.randint(-half, half, shape, generator=gen, device=dev,
                          dtype={32: torch.int64, 16: torch.int32, 8: torch.int32}[cfg.nbits])
        p = p.to(signed_view(torch.empty(0, dtype=cfg.storage_dtype)).dtype)
        p.view(-1)[:1] = -half
        out.append(p.view(cfg.storage_dtype))
    return out


def _same_f32(got, want):
    return all(torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


@pytest.mark.parametrize("round_to", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["phi3-kv", "mla-cr", "four-jobs"])
@pytest.mark.parametrize("cfg", [POSIT16, POSIT8], ids=["posit16", "posit8"])
def test_dequantize_many_at_linear_decode_shapes_on_card(dev, cfg, case, round_to):
    """One ``dequantize_many`` launch over a layer's two linear leaves
    (phi3's K and V, minicpm3's latent and RoPE key) and over four leaves
    of unequal lengths, f32 and bf16-rounded, bit for bit (``int32``
    views, NaR included) against ``dequantize_many_plain`` on the host;
    one launch counted a call, and the ``_call`` helper writes the same."""
    shapes = {"phi3-kv": [(8, 1024, 10, 128)] * 2,
              "mla-cr": [(8, 1024, 256), (8, 1024, 32)],
              "four-jobs": [(3, 1000, 7), (0,), (13,), (70_001,)]}[case]
    leaves = _leaves_on_card(dev, cfg, shapes, len(case))
    before = posit_codec.launches["posit_dequantize"]
    got = posit_codec.dequantize_many(leaves, cfg, round_to)
    assert posit_codec.launches["posit_dequantize"] == before + 1
    want = posit_codec.dequantize_many_plain([p.cpu() for p in leaves], cfg, round_to)
    assert [tuple(g.shape) for g in got] == [tuple(p.shape) for p in leaves]
    assert _same_f32(got, want)
    call, outs = posit_codec.dequantize_many_call(leaves, cfg, round_to)
    assert call() == 0
    assert _same_f32(outs, want)
    assert posit_codec.launches["posit_dequantize"] == before + 1


@pytest.mark.parametrize("round_to", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_dequantize_misaligned_views_on_card(dev, cfg, round_to):
    """Leaves that are views at element offsets 1-7 of their buffers (a
    ragged head before the source's first unit of four), lengths below one
    vector, at one and past one CTA's chunk, two leaves a launch."""
    for n in (1, 7, 16, 17, 1531, 100_003):
        (buf,) = _leaves_on_card(dev, cfg, [(n + 8,)], n)
        for off in range(8):
            a, b = buf[off:off + n], buf[8 - off:8 - off + n // 2]
            got = posit_codec.dequantize_many([a, b], cfg, round_to)
            want = posit_codec.dequantize_many_plain([a.cpu(), b.cpu()], cfg, round_to)
            assert _same_f32(got, want), (n, off)


def test_dequantize_bf16_keeps_nar_nan_on_card(dev):
    """NaR rounded through bf16 stays the codec's NaN 0x7FC00000, as the
    reference's ``astype(bfloat16)`` keeps it (torch's own cast of a NaN
    on the card may give other bits); every posit16 pattern."""
    p = torch.arange(1 << 16, dtype=torch.int64).to(POSIT16.storage_dtype)
    (got,) = posit_codec.dequantize_many([p.to(dev)], POSIT16, torch.bfloat16)
    assert int(got.view(torch.int32)[1 << 15]) == 0x7FC00000
    assert _same_f32([got], posit_codec.dequantize_many_plain([p], POSIT16, torch.bfloat16))


@pytest.mark.parametrize("kv", ["posit16", "posit8"])
@pytest.mark.parametrize("arch,compute", [("phi3-medium-14b", "bfloat16"),
                                          ("phi3-medium-14b", "float32"),
                                          ("minicpm3-4b", "float32")],
                         ids=["dense-bf16", "dense-f32", "mla"])
def test_linear_decode_one_dequantize_a_layer_on_card(dev, arch, compute, kv, monkeypatch):
    """Linear-cache decode steps on the card launch the dequantize once a
    layer a step (both leaves in one launch), and give the logits, bit for
    bit, of the same steps with the read's plain version."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(configs.get_config(arch).reduced(compute_dtype=compute),
                              kv_posit=kv)
    params = T.init_params(cfg, seed=3, device=dev)
    runs = []
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(posit_codec, "dequantize_many",
                                posit_codec.dequantize_many_plain)
        cache = T.init_cache(cfg, 3, 24, device=dev)
        gen = torch.Generator().manual_seed(4)
        logits = []
        for _ in range(6):
            tok = torch.randint(1, cfg.vocab, (3,), generator=gen).to(dev)
            before = posit_codec.launches["posit_dequantize"]
            out, cache = T.decode_step(params, cache, tok, cfg)
            assert posit_codec.launches["posit_dequantize"] - before == \
                (cfg.n_layers if fused else 0)
            logits.append(out.cpu())
        runs.append(torch.stack(logits))
    assert torch.equal(runs[0].view(torch.int32), runs[1].view(torch.int32))


@pytest.mark.parametrize("lane", ["dense", "mla"])
def test_decode_steps_fused_write_leave_same_arena_on_card(dev, lane, monkeypatch):
    """A few ``decode_step`` calls with posit16 KV leave the same arena
    bytes and logits with the fused write as with its plain version."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer as T

    arch = "minicpm3-4b" if lane == "mla" else "phi3-medium-14b"
    cfg = dataclasses.replace(configs.get_config(arch).reduced(compute_dtype="float32"),
                              kv_posit="posit16", paged_attn_kernel="fused")
    params = T.init_params(cfg, seed=1, device=dev)
    runs = []
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(posit_codec, "paged_write", posit_codec.paged_write_plain)
        cache = T.init_paged_cache(cfg, 3, 32, 4, 24, device=dev)
        cache["block_tables"][:] = torch.arange(24, dtype=torch.int32,
                                                device=dev).reshape(3, 8)
        cache["block_tables"][1, 2:] = 24            # row 1 runs into sentinels
        gen = torch.Generator().manual_seed(2)
        logits = []
        for _ in range(12):
            tok = torch.randint(1, cfg.vocab, (3,), generator=gen).to(dev)
            out, cache = T.decode_step(params, cache, tok, cfg,
                                       active=torch.tensor([True, True, False]))
            logits.append(out.cpu())
        runs.append((cache, torch.stack(logits)))
    (a, la), (b, lb) = runs
    for key in T.arena_keys(cfg):
        assert torch.equal(signed_view(a[key]), signed_view(b[key]))
    assert torch.equal(la.view(torch.int32), lb.view(torch.int32))


def _pats(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** cfg.nbits, size=shape, dtype=np.uint64)
    return torch.from_numpy(x.astype({8: np.uint8, 16: np.uint16,
                                      32: np.uint32}[cfg.nbits]))


def _eq(got, want):
    return torch.equal(signed_view(got.cpu()), signed_view(want))


def test_posit32_codec_bit_exact_on_card(dev):
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2**32, 1 << 18, dtype=np.uint64).astype(np.uint32)
    x = torch.from_numpy(bits.view(np.float32).copy())
    assert _eq(posit_codec.quantize(x.to(dev), POSIT32),
               posit_codec.quantize_plain(x, POSIT32))
    p = torch.from_numpy(bits.copy())
    got = posit_codec.dequantize(p.to(dev), POSIT32).cpu()
    assert torch.equal(got.view(torch.int32),
                       posit_codec.dequantize_plain(p, POSIT32).view(torch.int32))


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_elementwise_kernel_bit_exact_on_card(dev, cfg):
    a, b = _pats(cfg, (97, 131), 1), _pats(cfg, (97, 131), 2)
    for op, mode in (("add", "nr3"), ("sub", "nr3"), ("mul", "nr3"),
                     ("div", "nr3"), ("div", "exact")):
        want = posit_ew.elementwise_plain(a, b, cfg, op, mode)
        assert _eq(posit_ew.elementwise(a.to(dev), b.to(dev), cfg, op, mode), want)
        row = b[3]                                   # a broadcast row
        want = posit_ew.elementwise_plain(a, row, cfg, op, mode)
        assert _eq(posit_ew.elementwise(a.to(dev), row.to(dev), cfg, op, mode),
                   want)


@pytest.mark.parametrize("cfg", [POSIT16, POSIT32], ids=lambda c: c.name)
@pytest.mark.parametrize("length", [1, 147, 4096, 4097, 9000])
def test_dot_kernel_bit_exact_on_card(dev, cfg, length):
    a, b = _pats(cfg, (9, length), length), _pats(cfg, (9, length), length + 1)
    want = posit_dot.vpdot_rows_plain(a, b, cfg)
    assert _eq(posit_dot.vpdot_rows(a.to(dev), b.to(dev), cfg), want)


def test_dot_whole_cta_rows_at_scale_on_card(dev):
    """The whole-CTA width on 8 192 conv-length rows (thousands of CTAs
    in flight, so a race between its warps over the reduction's shared
    memory would show), three times, against the row-block width and
    the plain version."""
    cfg = POSIT32
    a = _specials(cfg, _pats(cfg, (8192, 147), 11), 3).to(dev)
    b = _specials(cfg, _pats(cfg, (8192, 147), 12), 4).to(dev)
    want = posit_dot.vpdot_rows_plain(a, b, cfg).cpu()
    assert _eq(posit_dot.vpdot_rows(a, b, cfg), want)
    for _ in range(3):
        call, out = posit_dot.vpdot_rows_call(a, b, cfg, group=256)
        assert call() == 0 and _eq(out, want)


_EW_OPS = [("add", "nr3"), ("sub", "nr3"), ("mul", "nr3"), ("div", "nr3"), ("div", "exact")]


def _specials(cfg, x, seed):
    """``x`` with zero, NaR, maxpos and minpos planted at seeded places."""
    s = signed_view(x.clone()).reshape(-1)
    idx = torch.from_numpy(np.random.default_rng(seed).choice(s.numel(), 4, replace=False))
    s[idx] = signed_view(torch.tensor([0, cfg.nar_pattern, cfg.maxpos_pattern, 1]).to(
        cfg.storage_dtype))
    return s.reshape(x.shape).view(cfg.storage_dtype)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
@pytest.mark.parametrize("op,mode", _EW_OPS, ids=[f"{o}_{m}" for o, m in _EW_OPS])
def test_elementwise_operand_modes_on_card(dev, cfg, op, mode):
    """Full, scalar (both sides) and row (both sides, C = 37, no multiple
    of a vector) operands; views at odd element offsets (scalar loads in
    the vector loop); a shape of several grid strides with a ragged tail;
    every special as the scalar.  The plain version runs on the card."""
    for shape, seed in (((301, 37), 5), ((4099, 37 * 9), 6)):
        a = _specials(cfg, _pats(cfg, shape, seed), seed).to(dev)
        b = _specials(cfg, _pats(cfg, shape, seed + 1), seed + 1).to(dev)
        row = _pats(cfg, (shape[1],), seed + 2).to(dev)
        cases = [(a, b), (b[:1, :1], a), (a, b[:1, :1]), (row, b), (a, row)]
        wide = signed_view(_pats(cfg, (a.numel() + 3,), seed + 3)).to(dev)
        cases.append((wide[1:1 + a.numel()].view(cfg.storage_dtype).view(shape), b))
        cases.append((a, wide[3:3 + b.numel()].view(cfg.storage_dtype).view(shape)))
        for sp in (0, cfg.nar_pattern, cfg.maxpos_pattern, 1):
            s = torch.tensor([sp]).to(cfg.storage_dtype).to(dev)
            cases += [(s, b), (a, s)]
        for x, y in cases:
            want = posit_ew.elementwise_plain(x, y, cfg, op, mode)
            assert _eq(posit_ew.elementwise(x, y, cfg, op, mode), want.cpu())


def test_elementwise_call_and_launch_count_on_card(dev):
    a, b = _pats(POSIT16, (512, 130), 7).to(dev), _pats(POSIT16, (130,), 8).to(dev)
    before = posit_ew.launches["posit_ew"]
    want = posit_ew.elementwise(a, b, POSIT16, "add")
    assert posit_ew.launches["posit_ew"] == before + 1
    call, out = posit_ew.elementwise_call(a, b, POSIT16, "add")
    assert call() == 0 and posit_ew.launches["posit_ew"] == before + 1
    assert _eq(out, want.cpu())


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
@pytest.mark.parametrize("length", [1, 16, 80, 81, 147, 160, 161, 320, 321, 4095, 4096,
                                    4097, 9000])
def test_dot_group_widths_on_card(dev, cfg, length):
    """The wrapper's group width at the edges of each range; 37 rows (no
    multiple of a row block); zero and NaR; operands as views at odd
    element offsets (ragged heads and tails of every staged span); and
    the whole-CTA width forced on the short rows."""
    rows = 37
    a = _specials(cfg, _pats(cfg, (rows, length), length), 1).to(dev)
    b = _specials(cfg, _pats(cfg, (rows, length), length + 1), 2).to(dev)
    want = posit_dot.vpdot_rows_plain(a, b, cfg).cpu()
    assert _eq(posit_dot.vpdot_rows(a, b, cfg), want)
    wa = torch.zeros(rows * length + 1, dtype=torch.int64, device=dev)
    wb = torch.zeros(rows * length + 5, dtype=torch.int64, device=dev)
    sa, sb = signed_view(wa.to(signed_view(a).dtype)), signed_view(wb.to(signed_view(b).dtype))
    sa[1:] = signed_view(a).reshape(-1)
    sb[5:] = signed_view(b).reshape(-1)
    va = sa[1:].view(rows, length).view(cfg.storage_dtype)
    vb = sb[5:].view(rows, length).view(cfg.storage_dtype)
    assert _eq(posit_dot.vpdot_rows(va, vb, cfg), want)
    call, out = posit_dot.vpdot_rows_call(va, vb, cfg, group=256)
    assert call() == 0 and _eq(out, want)


@pytest.mark.parametrize("cfg", [POSIT8, POSIT16, POSIT32], ids=lambda c: c.name)
@pytest.mark.parametrize("mkn", [(5, 37, 7), (33, 129, 19), (16, 4097, 16),
                                 (3, 8193, 70), (17, 12289, 65), (16, 17920, 64)])
def test_pgemm_kernel_bit_exact_on_card(dev, cfg, mkn):
    """Tiles of 16 x 64 outputs with ragged M and N, one to five quire
    tiles of K (the last ragged), against the plain version (run on the
    card: it is device-agnostic tensor code) and the per-output dot."""
    m, k, n = mkn
    a, w = _pats(cfg, (m, k), m), _pats(cfg, (k, n), n)
    want = posit_qgemm.posit_qgemm_plain(a.to(dev), w.to(dev), cfg).cpu()
    got = posit_qgemm.posit_qgemm(a.to(dev), w.to(dev), cfg)
    assert _eq(got, want)
    per_out = ops.dot(a.to(dev)[:, None, :],
                      signed_view(w).T.contiguous().view(w.dtype).to(dev)[None], cfg)
    assert _eq(per_out, got.cpu())


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_pgemm_kernel_edges_on_card(dev, cfg):
    """NaR in one row's last tile, a zero column, a row whose middle
    tile is all zero (an empty state in the fold), maxpos and minpos."""
    m, k, n = 5, 12289, 70
    a = signed_view(_pats(cfg, (m, k), 7))
    w = signed_view(_pats(cfg, (k, n), 8))
    nar, maxpos = signed_view(torch.tensor([cfg.nar_pattern, cfg.maxpos_pattern]).to(
        cfg.storage_dtype))
    a[a == nar] = 1
    w[w == nar] = 1
    a[0, k - 1] = nar
    w[:, 1] = 0
    a[1, 4096:8192] = 0
    a[2, ::2] = maxpos
    a[2, 1::4] = 1
    a, w = a.view(cfg.storage_dtype), w.view(cfg.storage_dtype)
    want = posit_qgemm.posit_qgemm_plain(a.to(dev), w.to(dev), cfg).cpu()
    got = posit_qgemm.posit_qgemm(a.to(dev), w.to(dev), cfg).cpu()
    assert _eq(got, want)
    assert (signed_view(got)[0] == nar).all() and (signed_view(got)[1:, 1] == 0).all()


def _read_case(cfg, lane, seed):
    """Leaves of one layer (K/V pairs, or MLA's latent and RoPE key) with
    zero and NaR planted in every block, a virtual table with sentinel
    and out-of-range entries, an all-masked row; the window lane's table
    and ``low_pos`` from ``_chunk_virtual_tables`` on a 40-token ring."""
    from repro_torch.models import transformer as T

    rng = np.random.default_rng(seed)
    b, bs, nb, vw = 4, 16, 40, 8
    feats = {"dense": ((10, 128), (10, 128)), "window": ((10, 128), (10, 128)),
             "mla": ((256,), (32,)), "odd": ((3, 5),)}[lane]
    leaves = []
    for f in feats:
        x = _pats(cfg, (nb, bs) + f, seed + len(leaves))
        flat = signed_view(x).view(nb, bs, -1)
        flat[:, 1, :2] = signed_view(torch.tensor([0, cfg.nar_pattern]).to(cfg.storage_dtype))
        leaves.append(x)
    lens = torch.tensor([100, 37, 128, 0])
    if lane == "window":
        rw = L.paged_window_blocks(40, bs)
        ring = torch.from_numpy(rng.permutation(nb)[:b * rw].reshape(b, rw).astype(np.int32))
        vt, low = T._chunk_virtual_tables(ring, lens, bs, 40, vw, nb)
        assert int(low[0]) > 0
    else:
        vt = torch.from_numpy(rng.permutation(nb)[:b * vw].reshape(b, vw).astype(np.int32))
        vt[0, 7] = nb                                   # sentinel
        vt[1, 1] = nb + 9                               # out of range, resident
        vt[2, 0] = -1
        low = torch.tensor([0, 5, 0, 0])
    return leaves, vt.to(torch.int32).contiguous(), lens.to(torch.int64), low.to(torch.int64)


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", [POSIT16, POSIT8], ids=["posit16", "posit8"])
@pytest.mark.parametrize("lane", ["dense", "window", "mla", "odd"])
def test_paged_read_matches_plain_on_card(dev, lane, cfg, out):
    """The fused chunked-prefill read (16-byte vectors; ``odd`` widths
    take the scalar loop) equals gather, dequantize, cast and mask bit
    for bit, NaN patterns included."""
    leaves, vt, lens, low = _read_case(cfg, lane, seed=cfg.nbits)
    on = ([x.to(dev) for x in leaves], vt.to(dev), lens.to(dev), low.to(dev))
    want = posit_codec.paged_read_plain(*on, cfg, out)
    got = posit_codec.paged_read(*on, cfg, out)
    iv = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[out]
    assert len(got) == len(leaves)
    for g, x in zip(got, want):
        assert g.dtype == out and g.shape == x.shape
        assert torch.equal(g.view(iv), x.view(iv))
        assert bool(torch.isnan(g.float()).any()) and not g[-1].view(iv).any()


@pytest.mark.parametrize("cfg", [POSIT16, POSIT8], ids=lambda c: c.name)
def test_gemm_kernel_matches_plain_on_card(dev, cfg):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)
    m, k, n = 70, 300, 130
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dev)
    w = posit_codec.quantize(
        torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(dev), cfg)
    got = posit_gemm.posit_gemm(a, w, cfg)
    wd = posit_codec.dequantize(w, cfg)
    want = posit_gemm.posit_gemm_plain(a, w, cfg)
    bound = 2 * k * 2.0 ** -24 * (a.abs().double() @ wd.abs().double())
    assert ((got.double() - want.double()).abs() <= bound).all()


# tile edges of the gemm kernel: BM 128, BN 128 (64 when N <= 64), BK 16
GEMM_EDGE_SHAPES = [(1, 1, 1), (127, 15, 63), (128, 16, 64), (129, 17, 65),
                    (128, 16, 128), (129, 33, 129), (300, 147, 64),
                    (257, 147, 200), (64, 1024, 256), (33, 4100, 130)]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
@pytest.mark.parametrize("mkn", GEMM_EDGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gemm_kernel_tile_edges_on_card(dev, cfg, mkn):
    """M, N, K below, at and above the tile sizes, the conv's K 147 and
    N 64, shapes that split K: within the f32 order bound of the plain
    version, and two calls bit-identical."""
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = mkn
    rng = np.random.default_rng(m * k + n)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dev)
    w = posit_codec.quantize(torch.from_numpy(
        (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)).to(dev), cfg)
    got = posit_gemm.posit_gemm(a, w, cfg)
    again = posit_gemm.posit_gemm(a, w, cfg)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    wd = posit_codec.dequantize(w, cfg)
    want = posit_gemm.posit_gemm_plain(a, w, cfg)
    bound = 2 * k * 2.0 ** -24 * (a.abs().double() @ wd.abs().double())
    assert ((got.double() - want.double()).abs() <= bound).all()


@pytest.mark.parametrize("plan", [(64, 1), (128, 1), (128, 3), (64, 8)],
                         ids=["bn64", "bn128", "bn128-split3", "bn64-split8"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_gemm_kernel_plans_and_scalar_paths_on_card(dev, plan, aligned):
    """Every tile width and split count on a ragged shape, with the
    operands' bases 16-byte aligned or one element off (the scalar load
    paths)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = POSIT16
    m, k, n = 131, 520, 136
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = posit_codec.quantize(torch.from_numpy(
        (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)), cfg)
    if aligned:
        ad, wdev = a.to(dev), w.to(dev)
    else:
        fa = torch.empty(m * k + 1, device=dev)
        fa[1:] = a.reshape(-1).to(dev)
        ad = fa[1:].view(m, k)
        fw = torch.empty(k * n + 1, dtype=w.dtype, device=dev)
        signed_view(fw)[1:] = signed_view(w).reshape(-1).to(dev)
        wdev = fw[1:].view(k, n)
    call, got = posit_gemm.posit_gemm_call(ad, wdev, cfg, plan=plan)
    assert call() == 0
    want = posit_gemm.posit_gemm_plain(a, w, cfg)
    bound = 2 * k * 2.0 ** -24 * (a.abs().double() @ posit_codec.dequantize(
        w, cfg).abs().double())
    assert ((got.cpu().double() - want.double()).abs() <= bound).all()


# ---------------------------------------------------------------------------
# the shapes the other transformer architectures give the serving kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", [None, "posit16", "posit8"])
@pytest.mark.parametrize("g,r,d", [(16, 1, 256), (1, 48, 128), (8, 3, 64), (2, 7, 64),
                                   (8, 6, 128), (5, 4, 128), (1, 24, 128)],
                         ids=["gemma-g16-r1-d256", "granite34b-g1-r48", "granite-moe-g8-r3",
                              "internvl-g2-r7", "dbrx-g8-r6", "phi3-mp2-g5-r4",
                              "granite34b-mp2-g1-r24"])
@pytest.mark.parametrize("chunk", [None, 1, 3], ids=["auto", "c1", "c3"])
def test_paged_attention_arch_shapes_on_card(dev, kv, g, r, d, chunk):
    """``paged_attn.cu`` at the architectures' head shapes: head_dim 256
    (the ``Dv > 128`` instantiation), MQA's 48 query heads on one KV head
    (six head groups), and R 3, 6 and 7 (heads that do not fill a
    warp's pairs), and a rank's heads under tensor parallelism at mp 2
    (phi3's 5 KV heads of 4 query heads; granite-34b's 24 query heads on
    its replicated KV head), over several splits, sentinel runs and an
    all-masked row; within 1e-5 of the plain version."""
    args, pcfg = _split_case(kv, d, 16, 0, r, g=g)
    ref = K.paged_decode_attention_plain(*args, pcfg=pcfg, window=0)
    on = [t.to(dev) for t in args]
    if chunk is None:
        got = K.paged_decode_attention(*on, pcfg=pcfg, window=0)
    else:
        call, got = K.paged_decode_attention_call(*on, pcfg=pcfg, window=0, chunk=chunk)
        assert call() == 0
    got = got.cpu()
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    assert torch.all(got[-1] == 0)


@pytest.mark.parametrize("cfg", [POSIT16, POSIT8], ids=["posit16", "posit8"])
@pytest.mark.parametrize("src", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("feat", [(16, 256), (1, 128), (5, 128)],
                         ids=["w4096-gemma", "w128-granite34b", "w640-phi3-mp2"])
def test_paged_write_and_read_at_arch_widths_on_card(dev, cfg, src, feat):
    """The fused write (a decode step's K and V of 8 rows, one with a
    dropped slot; a prefill leaf of 4 layers x 64 rows) and the fused
    read of a layer's two leaves at gemma's KV width 4 096,
    granite-34b's 128 and a phi3 rank's 640 at mp 2 (5 of its 10 KV
    heads), bit for bit against their plain versions."""
    rng = np.random.default_rng(cfg.nbits + feat[0])
    gen = torch.Generator(device=dev).manual_seed(feat[0])
    nb, bs, b, vw = 48, 16, 4, 8

    def check(jobs, slots):
        want = [(a.clone(), x) for a, x in jobs]
        posit_codec.paged_write_plain(want, slots, cfg)
        posit_codec.paged_write(jobs, slots, cfg)
        for (g, _), (w, _) in zip(jobs, want):
            assert torch.equal(signed_view(g), signed_view(w))

    arenas = [_pats(cfg, (4, nb, bs) + feat, seed).to(dev) for seed in (1, 2)]
    slots = torch.from_numpy(rng.permutation(nb * bs)[:8].astype(np.int64)).to(dev)
    slots[5] = -1
    check([(a[0], torch.randn((8,) + feat, generator=gen, device=dev).to(src))
           for a in arenas], slots)
    pslots = torch.from_numpy(rng.permutation(nb * bs)[:64].astype(np.int64)).to(dev)
    pslots[::9] = -1
    chunk = torch.randn((4, 64) + feat, generator=gen, device=dev).to(src)
    check([(arenas[0][li], chunk[li]) for li in range(4)], pslots)

    vt = torch.from_numpy(rng.permutation(nb)[:b * vw].reshape(b, vw).astype(np.int32))
    vt[0, 7] = nb                                       # sentinel
    lens = torch.tensor([100, 37, 128, 0])
    low = torch.tensor([0, 5, 0, 0])
    on = ([a[1] for a in arenas], vt.to(dev), lens.to(dev), low.to(dev))
    out = torch.bfloat16
    want = posit_codec.paged_read_plain(*on, cfg, out)
    got = posit_codec.paged_read(*on, cfg, out)
    for g, x in zip(got, want):
        assert g.shape == (b, vw * bs) + feat
        assert torch.equal(g.view(torch.int16), x.view(torch.int16))


# f32 on the card against the CPU: sums over D = 1 536 and F = 512 in
# other orders, values of size ~1, so a few f32 ulps; the routing equal
MOE_TOL = 1e-4


@pytest.mark.parametrize("s", [16, 1], ids=["chunk16", "decode"])
def test_moe_on_card_matches_cpu(dev, s):
    """granite-moe-3b-a800m's MoE feed-forward at full width (40 experts,
    top 8) in f32 with TF32 off: the same kept choices and outputs within
    ``MOE_TOL`` of its CPU run, and no host sync inside the call."""
    import dataclasses

    from repro_torch import configs

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_config("granite-moe-3b-a800m"),
                              compute_dtype="float32")
    gen = torch.Generator().manual_seed(s)
    p = L.init_moe(gen, cfg)
    x = torch.randn((8, s, cfg.d_model), generator=gen)
    want = L.moe(p, x, cfg)
    keep = L._moe_dispatch(p, x, cfg)[1][2]
    pd = {k: ({"w": v["w"].to(dev)} if k == "router" else v.to(dev)) for k, v in p.items()}
    xd = x.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = L.moe(pd, xd, cfg)
        got_keep = L._moe_dispatch(pd, xd, cfg)[1][2]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got_keep.cpu(), keep)
    torch.testing.assert_close(got.cpu(), want, atol=MOE_TOL, rtol=MOE_TOL)


# ---------------------------------------------------------------------------
# the hymba, rwkv6 and whisper families: their codec shapes, their engines
# ---------------------------------------------------------------------------

FAMILY_READS = {"hymba-ring": (8, 1024, 5, 64), "whisper-self": (8, 448, 6, 64),
                "whisper-cross": (8, 1500, 6, 64)}


@pytest.mark.parametrize("out", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("leaf", list(FAMILY_READS))
def test_dequantize_at_family_shapes_on_card(dev, leaf, out):
    """A layer's K and V in one dequantize launch at hymba-1.5b's ring
    and whisper-tiny's self and cross leaves, f32 and bf16-rounded out,
    bit for bit against the plain version (NaR at each leaf's head)."""
    leaves = [_pats(POSIT16, FAMILY_READS[leaf], seed).to(dev) for seed in (3, 4)]
    for p in leaves:
        signed_view(p).view(-1)[0] = -(1 << 15)
    got = posit_codec.dequantize_many(leaves, POSIT16, out)
    want = posit_codec.dequantize_many_plain([p.cpu() for p in leaves], POSIT16, out)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))


def test_quantize_at_whisper_cross_shape_on_card(dev):
    """whisper-tiny's cross K of one layer, (8, 1 500, 6, 64) f32 ->
    posit16, bit for bit against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((8, 1500, 6, 64), generator=gen, device=dev) * 3
    got = posit_codec.quantize(x, POSIT16)
    assert torch.equal(signed_view(got).cpu(),
                       signed_view(posit_codec.quantize_plain(x.cpu(), POSIT16)))


@pytest.mark.parametrize("leaf,pos,ring", [("hymba-ring", 1500, True),
                                           ("whisper-self", 300, False),
                                           ("whisper-self", 448, False)],
                         ids=["hymba-ring-wrapped", "whisper-self", "whisper-self-full"])
def test_linear_write_at_family_shapes_on_card(dev, leaf, pos, ring):
    """The fused write of a decode step's K and V (8 bf16 rows) into
    hymba-1.5b's ring past its wrap and whisper-tiny's self leaves (a
    write past the capacity dropped), bit for bit against the plain
    version."""
    shape = FAMILY_READS[leaf]
    leaves = [_pats(POSIT16, shape, seed).to(dev) for seed in (6, 7)]
    gen = torch.Generator(device=dev).manual_seed(pos)
    rows = [torch.randn((8,) + shape[2:], generator=gen, device=dev).to(torch.bfloat16)
            for _ in leaves]
    slots = L.linear_write_slots(8, shape[1], pos, ring=ring, device=dev)
    want = [a.clone() for a in leaves]
    posit_codec.paged_write_plain(list(zip(want, rows)), slots, POSIT16)
    before = [a.clone() for a in leaves]
    posit_codec.paged_write(list(zip(leaves, rows)), slots, POSIT16)
    for g, w, a in zip(leaves, want, before):
        assert torch.equal(signed_view(g), signed_view(w))
        assert torch.equal(signed_view(g), signed_view(a)) == (pos >= shape[1] and not ring)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("arch,kv,kernels", [
    ("hymba-1.5b", "posit16", ("posit_paged_write", "posit_dequantize")),
    ("rwkv6-7b", None, ()),
    ("whisper-tiny", "posit16", ("posit_quantize", "posit_paged_write", "posit_dequantize")),
], ids=["hymba", "rwkv6", "whisper"])
def test_family_oneshot_on_card_matches_cpu(dev, arch, kv, kernels):
    """Each family's reduced one-shot engine on the card, its kernels
    launched, against the same engine on the CPU in f32 (TF32 off): the
    same greedy tokens, prefill logits within 1e-4, ``generate_stepwise``
    equal, and no posit kernel launched on rwkv6."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import get_family
    from repro_torch.runtime.engine import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_config(arch).reduced(compute_dtype="float32"),
                              kv_posit=kv)
    params = get_family(cfg).init_params(cfg, seed=4, device="cpu")
    rng = np.random.default_rng(4)
    prompts = rng.integers(1, cfg.vocab, (3, 16))
    kw = {}
    if cfg.family == "whisper":
        kw["frames"] = rng.standard_normal((3, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    want = Engine(cfg, params, max_len=32, device="cpu").generate(prompts, 12, **kw)
    eng = Engine(cfg, _to(params, dev), max_len=32, device="cuda")
    before = {k: posit_codec.launches[k] for k in posit_codec.launches}
    got = eng.generate(prompts, 12, **kw)
    launched = {k: posit_codec.launches[k] - before[k] for k in before}
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.prefill_logits, want.prefill_logits, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(eng.generate_stepwise(prompts, 12, **kw).tokens, got.tokens)
    assert {k for k, v in launched.items() if v} == set(kernels)


# ---------------------------------------------------------------------------
# Training: AdamW's posit moments, error feedback, the checkpoint payload
# ---------------------------------------------------------------------------

def _plain_on_card(fn, out_dtype):
    def run(x):
        out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
        signed_view(out).view(-1).copy_(signed_view(fn(x.reshape(-1))))
        return out
    return run


@pytest.mark.parametrize("shape", [(3072,), (512, 768), (4, 96, 64)],
                         ids=["scale-1d", "weight-2d", "experts-3d"])
def test_adamw_posit_moments_on_card_equal_plain(dev, shape, monkeypatch):
    """Three updates of one leaf with posit16 moments on the codec kernels
    against the same updates with the plain codec on the card: parameters,
    m patterns and v bit for bit; the kernels launch once a leaf and an
    update each way (and once at init), the plain run not at all."""
    from repro_torch.optim import adamw

    cfg = adamw.AdamWConfig(lr=1e-2, posit_moments=True)
    gen = torch.Generator(device=dev).manual_seed(7)
    p0 = torch.randn(shape, generator=gen, device=dev)
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(adamw, "quantize_m", _plain_on_card(
                lambda x: posit_codec.quantize_plain(x, POSIT16), torch.uint16))
            monkeypatch.setattr(adamw, "dequantize_m", _plain_on_card(
                lambda q: posit_codec.dequantize_plain(q, POSIT16), torch.float32))
        p = p0.clone()
        before = dict(posit_codec.launches)
        state = adamw.init({"w": p}, cfg)
        m, v = state["m"]["w"], state["v"]["w"]
        g_gen = torch.Generator(device=dev).manual_seed(8)
        for step in range(3):
            g = torch.randn(shape, generator=g_gen, device=dev) * (0.1 + step)
            c = adamw.coefficients({"w": g}, state, cfg, torch.tensor(0.5, device=dev))
            m = adamw.update_leaf(p, g, m, v, c, cfg)
            state = {"m": {"w": m}, "v": {"w": v}, "count": c.count}
        launched = {k: posit_codec.launches[k] - before[k] for k in before}
        runs.append((p, m, v, launched))
    (pk, mk, vk, lk), (pp, mp, vp, lp) = runs
    assert torch.equal(pk.view(torch.int32), pp.view(torch.int32))
    assert torch.equal(vk.view(torch.int32), vp.view(torch.int32))
    assert mk.dtype == torch.uint16 and torch.equal(signed_view(mk), signed_view(mp))
    assert lk["posit_quantize"] == 4 and lk["posit_dequantize"] == 3
    assert lp["posit_quantize"] == 0 and lp["posit_dequantize"] == 0


@pytest.mark.parametrize("name", ["posit16", "posit8"])
def test_compress_with_feedback_on_card_equals_plain(dev, name):
    from repro_torch.compress import gradient as gc

    rng = np.random.default_rng(9)
    grads = {"w": torch.from_numpy(rng.standard_normal((64, 130)).astype(np.float32)),
             "layers": [{"b": torch.from_numpy(
                 (1e-3 * rng.standard_normal(77)).astype(np.float32))}]}
    err = gc.init_error_state(grads)
    want_q, want_e = gc.compress_with_feedback(grads, err, name)
    want_q, want_e = gc.compress_with_feedback(grads, want_e, name)
    before = dict(posit_codec.launches)
    err = gc.init_error_state(_to(grads, dev))
    got_q, got_e = gc.compress_with_feedback(_to(grads, dev), err, name)
    got_q, got_e = gc.compress_with_feedback(_to(grads, dev), got_e, name)
    assert posit_codec.launches["posit_quantize"] - before["posit_quantize"] == 4
    assert posit_codec.launches["posit_dequantize"] - before["posit_dequantize"] == 4
    for a, b in ((got_q["w"], want_q["w"]), (got_q["layers"][0]["b"], want_q["layers"][0]["b"])):
        assert a.device.type == "cuda" and torch.equal(signed_view(a.cpu()), signed_view(b))
    for a, b in ((got_e["w"], want_e["w"]), (got_e["layers"][0]["b"], want_e["layers"][0]["b"])):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


def test_checkpoint_posit_payload_on_card_equals_plain(dev, tmp_path):
    """The payload quantized on the card (row 1) is the CPU's file, bit for
    bit, and its restore onto the card (row 2) the CPU's values."""
    from repro_torch.checkpoint.checkpointer import Checkpointer

    rng = np.random.default_rng(10)
    tree = {"w": torch.from_numpy(rng.standard_normal((33, 70)).astype(np.float32)),
            "n": torch.tensor(3, dtype=torch.int32)}
    Checkpointer(str(tmp_path / "cpu"), posit_payload=True).save(1, tree, blocking=True)
    ck = Checkpointer(str(tmp_path / "gpu"), posit_payload=True)
    before = dict(posit_codec.launches)
    ck.save(1, _to(tree, dev), blocking=True)
    assert posit_codec.launches["posit_quantize"] - before["posit_quantize"] == 1
    a = np.load(tmp_path / "cpu" / "step_00000001" / "arrays.npz")
    b = np.load(tmp_path / "gpu" / "step_00000001" / "arrays.npz")
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    got, _ = ck.restore(1, _to(tree, dev))
    want, _ = Checkpointer(str(tmp_path / "cpu")).restore(1, tree)
    assert posit_codec.launches["posit_dequantize"] - before["posit_dequantize"] == 1
    assert got["w"].device.type == "cuda"
    assert torch.equal(got["w"].cpu().view(torch.int32), want["w"].view(torch.int32))
    assert int(got["n"]) == 3


TRAIN_ARCHS = ["gemma-7b", "minicpm3-4b", "granite-moe-3b-a800m", "hymba-1.5b", "rwkv6-7b",
               "whisper-tiny"]


def _worst_rel(got, want):
    """The largest |got - want| over each leaf's largest |want|, across
    the leaves of two trees."""
    from repro_torch import tree as TT
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(TT.leaves(got), TT.leaves(want)))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_card_matches_cpu(dev, arch, monkeypatch):
    """One reduced train step (``grad_accum`` 2, posit16 moments) on the
    card, the codec kernels launched once a leaf each, against the CPU in
    f32 with TF32 off, in two parts.  The step's loss and the gradients
    it hands the optimizer against the CPU's: the loss within rel 1e-5,
    each gradient leaf within 1e-4 of its largest magnitude (the two
    devices sum in other orders; the reference parity's tolerances).
    Its update against the CPU's update of the same parameters on those
    same gradients: parameters and ``v`` within 1e-6 of each leaf's
    largest magnitude (plus ``lr`` for the parameters: a leaf that starts
    at zero moves by about ``lr``), ``m`` patterns within one posit step,
    99.9 % equal (only the clip scale's global norm and ``pow`` differ
    between the devices).  Comparing the parameters after a whole step
    on each device's own gradients would not do: the first Adam step
    moves each one by about ``lr * sign(g)``, and where a gradient is
    within its tolerance of zero rounding decides that sign."""
    import dataclasses

    from repro_torch import configs
    from repro_torch import tree as TT
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models import get_family
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_config(arch).reduced(compute_dtype="float32"),
                              grad_accum=2)
    lr = 1e-2
    opt_cfg = adamw.AdamWConfig(lr=lr, posit_moments=True)
    cpu = torch.device("cpu")

    def init():
        return get_family(cfg).init_params(cfg, seed=2, device="cpu", dtype=torch.float32)

    # the CPU's gradient of the step's batch
    batch = Pipeline(DataConfig(seed=4), cfg, 4, 32, device=cpu).batch_at(100)
    want_loss, want_grads = train_loop.make_grad_fn(cfg)(init(), batch)
    want_grads = TT.tree_map(lambda g: g.clone(), want_grads)

    # the step on the card, its gradients and learning rate recorded
    seen = {}
    update = adamw.update

    def recording(grads, state, params, c, lr_scale=None, **kw):
        seen["grads"] = TT.tree_map(lambda g: g.detach().cpu().clone(), grads)
        seen["lr_scale"] = lr_scale.cpu()
        return update(grads, state, params, c, lr_scale, **kw)

    monkeypatch.setattr(adamw, "update", recording)
    params = _to(init(), dev)
    opt = adamw.init(params, opt_cfg)
    before = dict(posit_codec.launches)
    batch_dev = {k: v.to(dev) for k, v in batch.items()}
    params, opt, m = train_loop.make_train_step(cfg, opt_cfg, total_steps=3)(
        params, opt, batch_dev, 100)            # past the warm-up: lr itself
    launched = {k: posit_codec.launches[k] - before[k] for k in before}
    monkeypatch.setattr(adamw, "update", update)
    n = len(TT.leaves(params))
    assert launched["posit_quantize"] == n and launched["posit_dequantize"] == n
    assert abs(float(m["loss"]) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    worst = _worst_rel(seen["grads"], want_grads)
    assert worst <= 1e-4, worst

    # the CPU's update of the same parameters on the card's gradients
    p_cpu = init()
    opt_cpu = adamw.init(p_cpu, opt_cfg)
    p_cpu, opt_cpu, _ = adamw.update(seen["grads"], opt_cpu, p_cpu, opt_cfg,
                                     seen["lr_scale"])
    errs = []
    for a, b in zip(TT.leaves(_to(params, cpu)), TT.leaves(p_cpu)):
        errs.append(float((a - b).abs().max()) / (float(b.abs().max()) + lr))
    for a, b in zip(TT.leaves(_to(opt["v"], cpu)), TT.leaves(opt_cpu["v"])):
        errs.append(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
    steps, same = 0, 1.0
    for a, b in zip(TT.leaves(_to(opt["m"], cpu)), TT.leaves(opt_cpu["m"])):
        d = (signed_view(a).to(torch.int32) - signed_view(b).to(torch.int32)).abs()
        steps, same = max(steps, int(d.max())), min(same, float((d == 0).float().mean()))
    assert max(errs) <= 1e-6 and steps <= 1 and same >= 0.999, (max(errs), steps, same)


@pytest.mark.parametrize("cfg", [POSIT16, POSIT8], ids=["posit16", "posit8"])
def test_decompress_launches_the_dequantize_on_card(dev, cfg):
    """``compress.gradient.decompress`` on the card: one launch of the
    codec's dequantize a leaf, a pod-stacked ``(n_pods, ...)`` leaf
    included, bit-equal to the plain version (NaR too)."""
    from repro_torch.compress import gradient as gc

    name = "posit16" if cfg is POSIT16 else "posit8"
    rng = np.random.default_rng(7)
    tree = {"w": rng.integers(0, 1 << cfg.nbits, (2, 96, 40)),
            "b": np.append(rng.integers(0, 1 << cfg.nbits, 37), 1 << (cfg.nbits - 1))}
    host = {k: torch.from_numpy(v.astype(np.int64)).to(cfg.storage_dtype)
            for k, v in tree.items()}
    before = posit_codec.launches["posit_dequantize"]
    got = gc.decompress({k: v.to(dev) for k, v in host.items()}, name)
    assert posit_codec.launches["posit_dequantize"] == before + len(host)
    want = gc.decompress(host, name)
    for k in host:
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k].cpu().view(torch.int32), want[k].view(torch.int32))
