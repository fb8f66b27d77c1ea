"""The two quantizers themselves, run on the host: ``csrc/posit_codec.cu``'s
quantize and ``csrc/posit_paged_write.cu``, the fused quantize-and-write.

Both compile with ``g++`` against the CTA emulation of the CUDA runtime in
``cuda_host_stub.py`` (shared with ``test_torch_ew_dot_host.py``), and their
C entry points run on CPU tensors.  The outputs must equal the plain
versions (``posit_codec.quantize_plain``, ``posit_codec.paged_write_plain``)
bit for bit: the quantize on all five configs, with a ragged head and tail,
source and output views at element offsets 1-7, ``n`` below one vector and
zero, and a persistent grid striding over several passes; the write on
decode (2 jobs) and prefill (one job a layer) lists, rows dropped as
negative, past ``n_slots`` and through a sentinel, widths that are not whole
vectors, f32 and bf16 sources, posit16 and posit8, slots not written left
untouched.  On a subset, against the reference's Pallas ``quantize_2d`` in
interpret mode and its ``_maybe_quant_kv`` + cache write.  This runs the
kernels' indexing and their shared-memory table where no card is; the
encode itself is held to ``core.convert.f32_to_posit`` on every exponent in
``test_torch_csrc_host.py``.  Skipped where ``g++`` is missing.
"""
import ctypes
import dataclasses
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuda_host_stub
from repro import configs as RCFG
from repro.core import types as RT
from repro.kernels import posit_codec as RK
from repro.models import layers as RL
from repro.models import transformer as RTF
from repro_torch.core.types import CONFIGS, POSIT8, POSIT16, signed_view
from repro_torch.kernels import _build
from repro_torch.kernels import posit_codec as C
from repro_torch.models import layers as L

NP = {8: np.uint8, 16: np.uint16, 32: np.uint32}
REF_CFG = {"posit8e2": RT.POSIT8, "posit16e2": RT.POSIT16, "posit32e2": RT.POSIT32}
KIND = {torch.float32: 0, torch.bfloat16: 1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are many small int64 ops: under the suite's
    parallel workers torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host run of the kernels needs it")
    d = tmp_path_factory.mktemp("quantize_host")
    (d / "cuda_runtime.h").write_text(cuda_host_stub.STUB)
    with ThreadPoolExecutor(2) as pool:
        codec, write = pool.map(lambda n: cuda_host_stub.build(gxx, d, _build.CSRC, n),
                                ["posit_codec", "posit_paged_write"])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    codec.posit_quantize.argtypes = [I, I, P, P, LL, I, P]
    codec.posit_quantize.restype = I
    for fn in (write.posit_paged_write, write.posit_paged_write_floor):
        fn.argtypes = [I, I, I, P, P, P, P, LL, LL, P]
        fn.restype = I
    return codec, write


def _bits(t):
    return signed_view(t).to(torch.int64)


def _f32(n, seed):
    """Seeded f32 values: every exponent (random bits, NaNs and infs among
    them) on odd elements, Gaussian KV-like values on even ones, and the
    specials and subnormals up front."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)
    x[::2] = rng.standard_normal((n + 1) // 2).astype(np.float32)
    sp = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -3e-39, 3.4e38, 1.0, -0.5],
                  np.float32)[:n]
    x[:sp.size] = sp
    return torch.from_numpy(x.copy())


def _quant_case(codec, cfg, x, x_off=0, out_off=0, sms=1):
    """The kernel on ``x`` read at element ``x_off`` of a buffer, written at
    element ``out_off`` of another, against ``quantize_plain``; nothing
    outside the output changes."""
    n = x.numel()
    xb = torch.zeros(n + x_off + 5, dtype=torch.float32)
    xb[x_off:x_off + n] = x
    ob = torch.zeros(n + out_off + 9, dtype=cfg.storage_dtype)
    signed_view(ob).fill_(0x5A5A5A5A & ((1 << (cfg.nbits - 1)) - 1))
    before = _bits(ob).clone()
    rc = codec.posit_quantize(cfg.nbits, cfg.es, xb[x_off:].data_ptr(), ob[out_off:].data_ptr(),
                              n, sms, None)
    assert rc == 0, rc
    got = ob[out_off:out_off + n]
    want = C.quantize_plain(x, cfg)
    bad = torch.nonzero(_bits(got) != _bits(want))[:5, 0].tolist()
    assert not bad, [(float(x[i]), int(_bits(got)[i]), int(_bits(want)[i])) for i in bad]
    assert torch.equal(_bits(ob)[:out_off], before[:out_off])
    assert torch.equal(_bits(ob)[out_off + n:], before[out_off + n:])


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_quantize_kernel_equals_plain(libs, cfg):
    """1 531 elements (a ragged tail after the vectors) at every pair of
    source and output offsets from 0 to 7 elements (a ragged head, a source
    not aligned with the output's vectors); lengths below one vector, one
    vector and zero."""
    codec, _ = libs
    x = _f32(1531, 1)
    for x_off in range(8):
        for out_off in (0, 1, 3, 7) if x_off else range(8):
            _quant_case(codec, cfg, x, x_off, out_off)
    for n in (1, 2, 3, 15, 16, 17):
        for off in (0, 5):
            _quant_case(codec, cfg, _f32(n, n), off, off)
    out = torch.zeros(4, dtype=cfg.storage_dtype)
    assert codec.posit_quantize(cfg.nbits, cfg.es, x.data_ptr(), out.data_ptr(), 0, 1,
                                None) == 0
    assert torch.equal(_bits(out), torch.zeros(4, dtype=torch.int64))


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_quantize_kernel_grid_stride(libs, cfg):
    """One SM's persistent grid (4 CTAs) over 2.5 passes of its chunks,
    aligned and at an odd output offset."""
    codec, _ = libs
    x = _f32(4 * 256 * 16 * 5 // 2 + 7, 2)
    _quant_case(codec, cfg, x, 0, 0)
    _quant_case(codec, cfg, x, 2, 1)


@pytest.mark.parametrize("name", sorted(REF_CFG))
def test_quantize_kernel_equals_pallas(libs, name):
    """A subset against the reference's Pallas ``quantize_2d`` in interpret
    mode: one (8, 100) block."""
    codec, _ = libs
    cfg = next(c for c in CONFIGS if c.name == name)
    x = _f32(800, 3)
    out = torch.zeros(800, dtype=cfg.storage_dtype)
    assert codec.posit_quantize(cfg.nbits, cfg.es, x.data_ptr(), out.data_ptr(), 800, 1,
                                None) == 0
    want = np.asarray(RK.quantize_2d(jnp.asarray(x.numpy().reshape(8, 100)), REF_CFG[name],
                                     interpret=True))
    np.testing.assert_array_equal(signed_view(out).numpy().view(NP[cfg.nbits]),
                                  want.reshape(-1))


def _write(write, cfg, jobs, slots, n_slots, floor=False):
    """The C entry on ``jobs`` [(arena, src)], every arena of ``n_slots``
    slots of its width."""
    n = len(jobs)
    srcs = (ctypes.c_void_p * n)(*[s.data_ptr() for _, s in jobs])
    arenas = (ctypes.c_void_p * n)(*[a.data_ptr() for a, _ in jobs])
    widths = (ctypes.c_int * n)(*[a.numel() // n_slots for a, _ in jobs])
    fn = write.posit_paged_write_floor if floor else write.posit_paged_write
    return fn(cfg.nbits, KIND[jobs[0][1].dtype], n, srcs, arenas, widths, slots.data_ptr(),
              slots.numel(), n_slots, None)


def _view(t, off):
    """``t`` copied into a buffer at element ``off`` (a contiguous view whose
    address is ``off`` elements past an aligned one)."""
    buf = torch.zeros(t.numel() + off, dtype=t.dtype)
    buf[off:] = t.reshape(-1)
    return buf[off:].view(t.shape)


def _write_case(write, cfg, widths, rows, slots, n_slots, src_dtype, seed, offs=(0, 0)):
    """Fresh random arenas of ``widths`` (one job each) and sources of
    ``rows`` rows, at element offsets ``offs`` (arena, source); the kernel's
    arenas against ``paged_write_plain``'s, and dropped rows' slots (and all
    never-named slots) untouched."""
    rng = np.random.default_rng(seed)
    jobs = []
    for w in widths:
        pats = rng.integers(0, 2 ** cfg.nbits, (n_slots, 1, w), dtype=np.uint64)
        arena = torch.from_numpy(pats.astype(NP[cfg.nbits]))
        src = torch.from_numpy((rng.standard_normal((rows, w)) *
                                np.exp2(rng.integers(-30, 30, (rows, w)))).astype(np.float32))
        src.view(-1)[:3] = torch.tensor([0.0, float("inf"), float("nan")])[:min(3, src.numel())]
        jobs.append((_view(arena, offs[0]), _view(src.to(src_dtype), offs[1])))
    want = [a.clone() for a, _ in jobs]
    C.paged_write_plain([(a, s) for a, (_, s) in zip(want, jobs)], slots, cfg)
    assert _write(write, cfg, jobs, slots, n_slots) == 0
    for (got, _), w in zip(jobs, want):
        assert torch.equal(_bits(got), _bits(w))
    return jobs


def _slots(rng, rows, n_slots):
    """Distinct destinations, with drops: negative (-1 and -7), at
    ``n_slots`` and past it."""
    s = torch.from_numpy(rng.permutation(n_slots)[:rows].astype(np.int64))
    drops = [-1, n_slots, -7, n_slots + 5]
    for i, d in zip(range(1, rows, 3), drops):
        s[i] = d
    return s


@pytest.mark.parametrize("cfg", [POSIT16, POSIT8], ids=lambda c: c.name)
@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_paged_write_kernel_decode_and_prefill_equal_plain(libs, cfg, src_dtype):
    """A decode write (2 jobs: K and V of 40 = 2 x 20 wide, and the MLA
    pair 256 and 32), a prefill write of one leaf of 3 layers (128-job
    table), and a single job; 11 and 21 rows with dropped ones."""
    _, write = libs
    rng = np.random.default_rng(cfg.nbits)
    n_slots = 48
    dec = _slots(rng, 11, n_slots)
    _write_case(write, cfg, (40, 40), 11, dec, n_slots, src_dtype, 1)
    _write_case(write, cfg, (256, 32), 11, dec, n_slots, src_dtype, 2)
    pre = _slots(rng, 21, n_slots)
    _write_case(write, cfg, (64, 64, 64), 21, pre, n_slots, src_dtype, 3)
    _write_case(write, cfg, (48,), 21, pre, n_slots, src_dtype, 4)


@pytest.mark.parametrize("cfg", [POSIT16, POSIT8], ids=lambda c: c.name)
@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_paged_write_kernel_ragged_widths_and_views(libs, cfg, src_dtype):
    """Widths that are no whole number of vectors (3, 20, 37: every row
    starts off a 16-byte boundary, ragged heads and tails), arenas and
    sources at element offsets 1-3 (rows whose source is not aligned with
    the slot's vectors), and rows that are all dropped."""
    _, write = libs
    rng = np.random.default_rng(cfg.nbits + 1)
    n_slots = 24
    slots = _slots(rng, 9, n_slots)
    for widths, offs in (((3, 20), (0, 0)), ((37, 37, 37), (0, 0)), ((40, 24), (1, 0)),
                         ((40, 24), (0, 3)), ((20, 37), (3, 1))):
        _write_case(write, cfg, widths, 9, slots, n_slots, src_dtype, sum(widths) + offs[0])
    _write_case(write, cfg, (40, 40), 9, torch.full((9,), -1, dtype=torch.int64), n_slots,
                src_dtype, 5)


@pytest.mark.parametrize("n_jobs,rows_per_cta", [(128, 8), (64, 4), (32, 2), (3, 1)])
def test_paged_write_kernel_rows_per_cta(libs, n_jobs, rows_per_cta):
    """16 rows of ``n_jobs`` jobs: the launch takes 8, 4, 2 or 1 rows a
    CTA (the most that still gives 256 CTAs), so a row's group of lanes is
    a warp, two, four or the whole CTA; widths alternate between whole
    vectors and a ragged 20."""
    _, write = libs
    rng = np.random.default_rng(n_jobs)
    assert -(-16 // rows_per_cta) * n_jobs >= 256 or rows_per_cta == 1
    slots = _slots(rng, 16, 40)
    _write_case(write, POSIT16, [(24, 20)[j % 2] for j in range(n_jobs)], 16, slots, 40,
                torch.bfloat16, n_jobs)


def test_paged_write_floor_writes_nothing(libs):
    """The launch-floor entry takes the write's arguments and touches no
    arena."""
    _, write = libs
    arena = torch.zeros((8, 1, 16), dtype=POSIT16.storage_dtype)
    src = torch.ones((4, 16))
    slots = torch.arange(4, dtype=torch.int64)
    assert _write(write, POSIT16, [(arena, src), (arena, src)], slots, 8, floor=True) == 0
    assert not _bits(arena).any()
    assert _write(write, POSIT16, [(arena, src)], slots, 8) == 0
    assert _bits(arena).any()


def _ref_cfg(kv):
    return dataclasses.replace(
        RCFG.get_config("phi3-medium-14b").reduced(compute_dtype="float32"), kv_posit=kv)


@pytest.mark.parametrize("kv", ["posit16", "posit8"])
def test_paged_write_kernel_equals_reference_quantize_and_cache_write(libs, kv):
    """A subset against the reference: a decode token through
    ``_maybe_quant_kv`` + ``paged_cache_update`` (an inactive row, a write
    through a sentinel entry) and a prefill chunk of two layers through
    ``_maybe_quant_kv`` + ``paged_pack_range``."""
    _, write = libs
    cfg = L.pcfg(kv)
    rng = np.random.default_rng(7)
    nb, bs, b, w, s, n_layers = 16, 4, 4, 4, 5, 2
    feat = (2, 8)
    tables = rng.permutation(nb)[:b * w].astype(np.int32).reshape(b, w)
    tables[1, 1] = nb
    pos = np.array([5, 6, 9, 2], np.int32)
    ok = np.array([True, True, True, False])
    arena = C.quantize_plain(torch.from_numpy(
        rng.normal(size=(n_layers, nb, bs) + feat).astype(np.float32)), cfg).numpy()
    rc = _ref_cfg(kv)
    one = rng.normal(size=(b,) + feat).astype(np.float32)
    ref = np.asarray(RL.paged_cache_update(jnp.asarray(arena[0]),
                                           RTF._maybe_quant_kv(jnp.asarray(one), rc),
                                           jnp.asarray(tables), jnp.asarray(pos),
                                           jnp.asarray(ok), window=0))
    got = torch.from_numpy(arena.copy())
    slots = L.paged_write_slots(torch.from_numpy(tables), torch.from_numpy(pos),
                                torch.from_numpy(ok), n_blocks=nb, block_size=bs)
    assert _write(write, cfg, [(got[0], torch.from_numpy(one))], slots, nb * bs) == 0
    np.testing.assert_array_equal(got[0].numpy(), ref)

    start, lens = np.array([0, 3, 9, 2], np.int32), np.array([5, 8, 12, 7], np.int32)
    chunk = rng.normal(size=(n_layers, b, s) + feat).astype(np.float32)
    ref = np.asarray(RL.paged_pack_range(jnp.asarray(arena),
                                         RTF._maybe_quant_kv(jnp.asarray(chunk), rc),
                                         jnp.asarray(tables), jnp.asarray(start),
                                         jnp.asarray(lens), window=0))
    got = torch.from_numpy(arena.copy())
    pslots = L.paged_pack_slots(torch.from_numpy(tables), torch.from_numpy(start),
                                torch.from_numpy(lens), s, n_blocks=nb,
                                block_size=bs).reshape(-1)
    x = torch.from_numpy(chunk)
    assert _write(write, cfg, [(got[li], x[li].reshape((b * s,) + feat))
                               for li in range(n_layers)], pslots, nb * bs) == 0
    np.testing.assert_array_equal(got.numpy(), ref)
