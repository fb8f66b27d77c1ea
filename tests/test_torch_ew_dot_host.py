"""``csrc/posit_ew.cu`` and ``csrc/posit_dot.cu`` themselves, run on the host.

The two kernels compile with ``g++`` against a small stand-in for the
CUDA runtime (``cuda_host_stub.py``, shared with the quantizers' host
run): a launch runs each CTA in turn as ``blockDim.x`` threads,
``__syncthreads`` is a barrier of the CTA's threads, a warp shuffle goes
through an exchange array between two barriers of the warp's threads,
dynamic shared memory is one buffer (filled with a junk pattern before
every CTA) and static ``__shared__`` arrays are function statics; the
sources copy with ``memcpy`` where the card runs ``cp.async``.  Their C
entry points then take CPU tensors' addresses, and the results must
equal the plain versions (``posit_ew.elementwise_plain``,
``posit_dot.vpdot_rows_plain``) bit for bit, and on a subset the
reference's Pallas kernels in interpret mode.  This runs the kernels'
indexing -- operand modes, the ragged head and tail of 16-byte vectors,
misaligned views, row blocks and group widths, tile staging and the
in-order fold -- where no card is; the arithmetic is ``csrc/pvu.cuh``'s,
checked exhaustively in ``test_torch_csrc_host.py``.  Skipped where
``g++`` is missing.
"""
import ctypes
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuda_host_stub
from repro.core import types as RT
from repro.kernels import posit_dot as RD
from repro.kernels import posit_ew as RE
from repro_torch.core.types import CONFIGS, POSIT8, POSIT16, POSIT32, signed_view
from repro_torch.kernels import _build
from repro_torch.kernels import posit_dot as D
from repro_torch.kernels import posit_ew as E

OPS = [("add", "nr3"), ("sub", "nr3"), ("mul", "nr3"), ("div", "nr3"),
       ("div", "exact")]
CODE = {("add", "nr3"): 0, ("sub", "nr3"): 1, ("mul", "nr3"): 2,
        ("div", "nr3"): 3, ("div", "exact"): 4}
FULL, SCALAR, ROW = 0, 1, 2
NP = {8: np.uint8, 16: np.uint16, 32: np.uint32}
REF_CFG = {"posit8e2": RT.POSIT8, "posit16e2": RT.POSIT16, "posit32e2": RT.POSIT32}



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
    d = tmp_path_factory.mktemp("ew_dot_host")
    (d / "cuda_runtime.h").write_text(cuda_host_stub.STUB)

    with ThreadPoolExecutor(2) as pool:
        ew, dot = pool.map(lambda n: cuda_host_stub.build(gxx, d, _build.CSRC, n),
                           ["posit_ew", "posit_dot"])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ew.posit_elementwise.argtypes = [I, I, I, P, I, I, P, I, I, P, LL, I, P]
    ew.posit_elementwise.restype = I
    dot.posit_dot_rows.argtypes = [I, I, P, P, P, LL, LL, I, P]
    dot.posit_dot_rows.restype = I
    return ew, dot


def _pats(cfg, n, seed, specials=True):
    """Seeded patterns with zero and NaR (and maxpos, minpos) planted."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** cfg.nbits, n, dtype=np.uint64).astype(NP[cfg.nbits])
    if specials and n >= 8:
        x[rng.choice(n, 6, replace=False)] = [0, cfg.nar_pattern, cfg.maxpos_pattern, 1,
                                              0, cfg.nar_pattern]
    return torch.from_numpy(x)


def _bits(t):
    return signed_view(t).to(torch.int64)


def _ew(lib, cfg, op, mode, a, ma, b, mb, out, n, sms=2):
    cols = [x.numel() if m == ROW else 0 for x, m in ((a, ma), (b, mb))]
    rc = lib.posit_elementwise(cfg.nbits, cfg.es, CODE[(op, mode)], a.data_ptr(), ma,
                               cols[0], b.data_ptr(), mb, cols[1], out.data_ptr(), n, sms,
                               None)
    assert rc == 0, rc


def _ew_case(lib, cfg, op, mode, a, ma, b, mb, shape, out_offset=0, sms=2):
    """The kernel on operands ``a``, ``b`` read in modes ``ma``, ``mb``
    into an output of ``shape`` (at element ``out_offset`` of a buffer)
    against the plain version on the broadcast operands."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + out_offset + 3, dtype=cfg.storage_dtype)
    out = buf[out_offset:out_offset + n]
    _ew(lib, cfg, op, mode, a, ma, b, mb, out, n, sms)
    want = E.elementwise_plain(a.reshape(shape) if ma == FULL else a,
                               b.reshape(shape) if mb == FULL else b, cfg, op, mode)
    got = out.reshape(shape)
    bad = torch.nonzero(_bits(got) != _bits(want))[:5]
    assert bad.numel() == 0, (op, mode, ma, mb, bad.tolist())
    # nothing written outside the output
    assert (_bits(buf[:out_offset]) == 0).all() and (_bits(buf[out_offset + n:]) == 0).all()


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
@pytest.mark.parametrize("op,mode", OPS, ids=[f"{o}_{m}" for o, m in OPS])
def test_ew_kernel_operand_modes_equal_plain(libs, cfg, op, mode):
    """Full, scalar-left, scalar-right, row-left and row-right operands;
    rows of C = 37 (no multiple of any vector width), ragged tails (n not
    a multiple of the vectors or the CTA chunk), an output at an odd
    element offset (a ragged head), a grid-stride walk over several
    chunks, zero and NaR among the patterns."""
    ew, _ = libs
    shape = (41, 37)                                  # 1 517 elements
    n = 41 * 37
    full_a, full_b = _pats(cfg, n, 1), _pats(cfg, n, 2)
    row = _pats(cfg, 37, 3)
    scalar = torch.tensor([int(_pats(cfg, 1, 4, specials=False)[0])]).to(cfg.storage_dtype)
    for out_offset in (0, 1):
        _ew_case(ew, cfg, op, mode, full_a, FULL, full_b, FULL, shape, out_offset)
        _ew_case(ew, cfg, op, mode, scalar, SCALAR, full_b, FULL, shape, out_offset)
        _ew_case(ew, cfg, op, mode, full_a, FULL, scalar, SCALAR, shape, out_offset)
        _ew_case(ew, cfg, op, mode, row, ROW, full_b, FULL, shape, out_offset)
        _ew_case(ew, cfg, op, mode, full_a, FULL, row, ROW, shape, out_offset)
    # every special as the scalar, on both sides
    for sp in (0, cfg.nar_pattern, cfg.maxpos_pattern, 1):
        s = torch.tensor([sp]).to(cfg.storage_dtype)
        _ew_case(ew, cfg, op, mode, s, SCALAR, full_b, FULL, shape)
        _ew_case(ew, cfg, op, mode, full_a, FULL, s, SCALAR, shape)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_ew_kernel_misaligned_views_and_edges(libs, cfg):
    """Full operands that are views at odd element offsets (scalar loads
    inside the vector loop), the output aligned and not, rows shorter
    than a vector (C = 3) and of one element, a 64-wide bias row against
    (n, 64) as in the conv, and outputs of 1, 2, 15 and 17 elements
    (all head and tail)."""
    ew, _ = libs
    shape = (9, 64)
    n = 9 * 64
    base_a, base_b = _pats(cfg, n + 5, 5), _pats(cfg, n + 5, 6)
    bias = _pats(cfg, 64, 7)
    for oa, ob, oo in ((1, 0, 0), (0, 3, 0), (1, 1, 0), (1, 1, 1), (2, 5, 3)):
        a, b = base_a[oa:oa + n], base_b[ob:ob + n]
        for op, mode in OPS:
            _ew_case(ew, cfg, op, mode, a, FULL, b, FULL, shape, oo)
        _ew_case(ew, cfg, "add", "nr3", a, FULL, bias, ROW, shape, oo)
        _ew_case(ew, cfg, "mul", "nr3", bias, ROW, b, FULL, shape, oo)
    for c in (1, 3):                                  # rows shorter than a vector
        _ew_case(ew, cfg, "sub", "nr3", base_a[:n], FULL, _pats(cfg, c, 8 + c, False), ROW,
                 (n // c, c), 1)
    for m in (1, 2, 15, 17):
        for oo in (0, 1):
            _ew_case(ew, cfg, "div", "exact", base_a[1:1 + m], FULL, base_b[:m], FULL, (m,), oo)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_ew_kernel_grid_stride(libs, cfg):
    """A grid of 8 CTAs (one SM's worth) striding over 2.5 passes of its
    chunks: each full, scalar and row operand's chunk bases and row
    columns advance with the stride."""
    ew, _ = libs
    per_pass = 8 * 256 * 2 * (16 // (cfg.nbits // 8))  # CTAs x threads x vectors x kV
    rows = (5 * per_pass // 2) // 37 + 1
    shape, n = (rows, 37), rows * 37
    a, b, row = _pats(cfg, n, 40), _pats(cfg, n, 41), _pats(cfg, 37, 42)
    s = torch.tensor([int(_pats(cfg, 1, 43, specials=False)[0])]).to(cfg.storage_dtype)
    _ew_case(ew, cfg, "add", "nr3", a, FULL, b, FULL, shape, 1, sms=1)
    _ew_case(ew, cfg, "mul", "nr3", a, FULL, s, SCALAR, shape, 0, sms=1)
    _ew_case(ew, cfg, "add", "nr3", row, ROW, b, FULL, shape, 0, sms=1)
    _ew_case(ew, cfg, "sub", "nr3", a, FULL, row, ROW, shape, 1, sms=1)


@pytest.mark.parametrize("name", sorted(REF_CFG))
def test_ew_kernel_equals_pallas(libs, name):
    """A subset against the reference's Pallas kernel in interpret mode:
    every op on one (8, 100) block."""
    ew, _ = libs
    cfg = next(c for c in CONFIGS if c.name == name)
    a, b = _pats(cfg, 800, 20), _pats(cfg, 800, 21)
    for op, mode in OPS:
        out = torch.zeros(800, dtype=cfg.storage_dtype)
        _ew(ew, cfg, op, mode, a, FULL, b, FULL, out, 800)
        want = np.asarray(RE.elementwise_2d(jnp.asarray(a.numpy().reshape(8, 100)),
                                            jnp.asarray(b.numpy().reshape(8, 100)),
                                            REF_CFG[name], op, mode))
        np.testing.assert_array_equal(signed_view(out).numpy().view(NP[cfg.nbits]),
                                      want.reshape(-1))


def _dot(lib, cfg, a, b, group):
    r, length = a.shape
    guard = signed_view(torch.tensor([cfg.nar_pattern]).to(cfg.storage_dtype))
    out = torch.zeros(r + 1, dtype=cfg.storage_dtype)
    signed_view(out)[r:] = guard
    rc = lib.posit_dot_rows(cfg.nbits, cfg.es, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                            r, length, group, None)
    assert rc == 0, rc
    assert torch.equal(signed_view(out)[r:], guard), "wrote past the output"
    return out[:r]


def _dot_operands(cfg, rows, length, seed):
    """Random rows with NaR kept out but for one row, an all-zero row, a
    row of ones against ones and zeros scattered in."""
    a = signed_view(_pats(cfg, rows * length, seed, specials=False).reshape(rows, length))
    b = signed_view(_pats(cfg, rows * length, seed + 1, specials=False).reshape(rows, length))
    nar = int(signed_view(torch.tensor([cfg.nar_pattern]).to(cfg.storage_dtype))[0])
    a[a == nar] = 1
    b[b == nar] = 1
    a[0, -1] = nar
    a[1] = 0
    if rows > 3:
        one = signed_view(torch.tensor([1 << (cfg.nbits - 2)]).to(cfg.storage_dtype))[0]
        a[2], b[2] = one, one
        b[3, ::3] = 0
    return a.view(cfg.storage_dtype).contiguous(), b.view(cfg.storage_dtype).contiguous()


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
@pytest.mark.parametrize("length", [1, 16, 147, 4095, 4096, 4097])
def test_dot_kernel_equals_plain(libs, cfg, length):
    """The wrapper's group width for L; 37 rows (not a multiple of any
    row block), the tile boundary at 4096, zero and NaR."""
    _, dot = libs
    rows = 37 if length <= 256 else 5
    a, b = _dot_operands(cfg, rows, length, length)
    got = _dot(dot, cfg, a, b, D.group_for(length))
    want = D.vpdot_rows_plain(a, b, cfg)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("group,length", [(8, 1), (8, 61), (8, 80), (16, 81), (16, 160),
                                          (32, 161), (32, 320), (256, 16), (256, 321),
                                          (256, 8195)])
@pytest.mark.parametrize("cfg", [POSIT8, POSIT16, POSIT32], ids=lambda c: c.name)
def test_dot_kernel_group_widths(libs, cfg, group, length):
    """Every group width at the edges of its range (and the whole-CTA
    width on short rows and across two tile boundaries); operands as
    views at an odd element offset, so every staged span has a ragged
    head and tail."""
    _, dot = libs
    rows = 3 if length > 4096 else 35
    a, b = _dot_operands(cfg, rows, length, group + length)
    a2 = torch.zeros(rows * length + 1, dtype=cfg.storage_dtype)
    b2 = torch.zeros(rows * length + 3, dtype=cfg.storage_dtype)
    signed_view(a2)[1:] = signed_view(a).reshape(-1)
    signed_view(b2)[3:] = signed_view(b).reshape(-1)
    got = _dot(dot, cfg, a2[1:].view(rows, length), b2[3:].view(rows, length), group)
    want = D.vpdot_rows_plain(a, b, cfg)
    assert torch.equal(_bits(got), _bits(want))


def test_dot_kernel_refuses_a_row_too_long_for_its_group(libs):
    _, dot = libs
    a = torch.zeros((2, 81), dtype=torch.uint16)
    out = torch.zeros(2, dtype=torch.uint16)
    assert dot.posit_dot_rows(16, 2, a.data_ptr(), a.data_ptr(), out.data_ptr(), 2, 81, 8,
                              None) != 0
    assert dot.posit_dot_rows(16, 2, a.data_ptr(), a.data_ptr(), out.data_ptr(), 2, 81, 12,
                              None) != 0


@pytest.mark.parametrize("name", sorted(REF_CFG))
def test_dot_kernel_equals_pallas(libs, name):
    """A subset against the reference's Pallas kernel in interpret mode:
    5 rows of 147 (the conv's windows) and of 4097 (two tiles)."""
    _, dot = libs
    cfg = next(c for c in CONFIGS if c.name == name)
    for length in (147, 4097):
        a, b = _dot_operands(cfg, 5, length, 30 + length)
        got = _dot(dot, cfg, a, b, D.group_for(length))
        want = np.asarray(RD.vpdot_rows(jnp.asarray(signed_view(a).numpy().view(NP[cfg.nbits])),
                                        jnp.asarray(signed_view(b).numpy().view(NP[cfg.nbits])),
                                        REF_CFG[name]))
        np.testing.assert_array_equal(signed_view(got).numpy().view(NP[cfg.nbits]), want)


def test_group_for_covers_every_length():
    assert [D.group_for(n) for n in (1, 80, 81, 147, 160, 161, 320, 321, 10 ** 6)] == \
        [8, 8, 16, 16, 16, 32, 32, 256, 256]
