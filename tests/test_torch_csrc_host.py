"""The device arithmetic of the ISA kernels, checked on the host.

``csrc/pvu.cuh`` is header-only C++ (``__host__ __device__``), so ``g++``
builds it into a small shared library here.  Its elementwise ops (add,
sub, mul, both dividers) and its quire dot (the kernels' tile loop,
run serially) are held bit for bit to the port's plain versions
(``repro_torch.core.posit``): every posit8 and posit8e0 pair, and seeded
2**16-pair samples with the edge patterns in posit16, posit16e1 and
posit32; its word-level placement ``place_add`` (the kernels' hot
loop) is held to ``place_product`` product by product.
``csrc/posit_narrow.cuh``, the decode inside the paged
attention and posit-weight gemm kernels, is held to the codec on every
pattern of the four configs of at most 16 bits; ``csrc/posit.cuh``'s
f32 encode, the quantizers' (a table entry per sign and exponent, one
rounding), to ``core.convert.f32_to_posit`` on every exponent and, in
posit8 and posit16, around every rounding midpoint.  This is the only check
of the kernels' arithmetic that runs without the card; skipped where
``g++`` is missing.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import posit as P
from repro_torch.core.convert import f32_to_posit, posit_to_f32
from repro_torch.core.types import (POSIT8, POSIT8_E0, POSIT16, POSIT16_E1,
                                    POSIT32, signed_view, to_storage)
from repro_torch.kernels import _build

CFGS = [POSIT8, POSIT8_E0, POSIT16, POSIT16_E1, POSIT32]
OPS = ["add", "sub", "mul", "div_nr3", "div_exact"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are many small int64 ops: under the suite's
    parallel workers torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SHIM = r"""
#include "posit_narrow.cuh"
#include "pvu.cuh"

namespace {

// PIR -> posit pattern with round-to-nearest-even (core/pir.py::encode) on
// a 64-bit stream: the reference form pvu::encode_fields is held to
template <int N, int ES>
inline uint32_t encode(uint32_t sign, int exp, uint32_t sig, uint32_t sticky) {
  const uint32_t mask = N < 32 ? ((1u << N) - 1u) : 0xFFFFFFFFu;
  const uint32_t maxpos = (1u << (N - 1)) - 1u;
  const int max_scale = (N - 2) * (1 << ES);
  const bool too_big = exp > max_scale;
  const bool too_small = exp < -max_scale;
  const int expc = posit::clampi(exp, -max_scale, max_scale);
  // floor division by 2^es without shifting a negative value
  const int r = expc >= 0 ? (expc >> ES) : -((-expc + (1 << ES) - 1) >> ES);
  const int e = expc - r * (1 << ES);

  const int reg_len = r >= 0 ? r + 2 : 1 - r;
  uint32_t v_reg = 1u;
  if (r >= 0) v_reg = (r + 2 >= 32) ? 0xFFFFFFFEu : (posit::sll32(2u, r + 1) - 2u);

  uint64_t stream = posit::sll64(v_reg, 64 - reg_len);
  if (ES > 0) stream |= posit::sll64(static_cast<uint32_t>(e), 64 - reg_len - ES);
  const uint32_t frac31 = sig & 0x7FFFFFFFu;
  const int fsh = 33 - reg_len - ES;                 // fraction LSB position
  stream |= fsh >= 0 ? posit::sll64(frac31, fsh) : posit::srl64(frac31, -fsh);
  if (fsh < 0 && (frac31 & (posit::sll32(1u, -fsh) - 1u)) != 0u) sticky = 1u;
  stream |= sticky;

  const uint32_t body = static_cast<uint32_t>(posit::srl64(stream, 64 - (N - 1)));
  const uint32_t round_bit = static_cast<uint32_t>(posit::srl64(stream, 64 - N) & 1ull);
  const uint32_t sticky_rest = (stream & (posit::sll64(1ull, 64 - N) - 1ull)) != 0ull;
  uint32_t p = body + (round_bit & (sticky_rest | (body & 1u)));
  p = p > maxpos ? maxpos : p;                       // never past maxpos
  p = p < 1u ? 1u : p;                               // never to zero
  if (too_big) p = maxpos;
  if (too_small) p = 1u;
  if (sign) p = (~p + 1u) & mask;
  return p;
}

template <int N, int ES>
void ew(int op, const uint32_t* a, const uint32_t* b, uint32_t* o, long long n) {
  for (long long i = 0; i < n; ++i) {
    switch (op) {
      case pvu::kAdd: o[i] = pvu::elementwise<N, ES, pvu::kAdd>(a[i], b[i]); break;
      case pvu::kSub: o[i] = pvu::elementwise<N, ES, pvu::kSub>(a[i], b[i]); break;
      case pvu::kMul: o[i] = pvu::elementwise<N, ES, pvu::kMul>(a[i], b[i]); break;
      case pvu::kDivNr3: o[i] = pvu::elementwise<N, ES, pvu::kDivNr3>(a[i], b[i]); break;
      default: o[i] = pvu::elementwise<N, ES, pvu::kDivExact>(a[i], b[i]); break;
    }
  }
}

// the kernels' tile loop, serially: per tile of kMaxDotLength the max
// product exponent, then the placed products, folded in order
template <int N, int ES>
void dot(const uint32_t* a, const uint32_t* b, uint32_t* o, long long rows,
         long long len) {
  for (long long r = 0; r < rows; ++r) {
    const uint32_t* x = a + r * len;
    const uint32_t* y = b + r * len;
    pvu::Quire s = pvu::quire_empty();
    for (long long t0 = 0; t0 < len; t0 += pvu::kMaxDotLength) {
      const long long t1 = t0 + pvu::kMaxDotLength < len ? t0 + pvu::kMaxDotLength : len;
      pvu::Quire t = pvu::quire_empty();
      for (long long i = t0; i < t1; ++i) {
        const pvu::Pir pa = pvu::decode<N, ES>(x[i]), pb = pvu::decode<N, ES>(y[i]);
        const int e = pvu::product_exp(pa, pb);
        t.m_exp = e > t.m_exp ? e : t.m_exp;
        t.nar = t.nar || pa.nar || pb.nar;
      }
      pvu::TileSum sum = pvu::tile_sum_empty();
      for (long long i = t0; i < t1; ++i) {
        const pvu::Pir pa = pvu::decode<N, ES>(x[i]), pb = pvu::decode<N, ES>(y[i]);
        pvu::place_add<(N <= 16)>(&sum, pvu::place_sig<(N <= 16)>(pa.sig),
                                  pvu::place_sig<(N <= 16)>(pb.sig), t.m_exp - (pa.exp + pb.exp),
                                  pa.sign ^ pb.sign);
      }
      t.acc = sum.acc + sum.ones;
      t.sticky = sum.sticky;
      s = pvu::quire_combine(s, t);
    }
    o[r] = pvu::quire_finalize<N, ES>(s);
  }
}

// place_add (narrow where the kernels take it, and wide) against
// place_product, one product each, against the
// alignment exponent m_exp = a.exp + b.exp + delta[i]; returns the count
// of products whose 128-bit contribution or sticky differ
template <int N, int ES>
long long place(const uint32_t* a, const uint32_t* b, const int* delta, long long n) {
  long long bad = 0;
  for (long long i = 0; i < n; ++i) {
    const pvu::Pir pa = pvu::decode<N, ES>(a[i]), pb = pvu::decode<N, ES>(b[i]);
    const int m_exp = pa.exp + pb.exp + delta[i];
    uint32_t st;
    const pvu::u128 want = pvu::place_product(pa, pb, m_exp, &st);
    pvu::TileSum t = pvu::tile_sum_empty(), w = pvu::tile_sum_empty();
    pvu::place_add<(N <= 16)>(&t, pvu::place_sig<(N <= 16)>(pa.sig),
                              pvu::place_sig<(N <= 16)>(pb.sig), m_exp - (pa.exp + pb.exp),
                              pa.sign ^ pb.sign);
    pvu::place_add<false>(&w, pa.sig, pb.sig, m_exp - (pa.exp + pb.exp), pa.sign ^ pb.sign);
    bad += (t.acc + t.ones != want || t.sticky != st) ? 1 : 0;
    bad += (w.acc + w.ones != want || w.sticky != st) ? 1 : 0;
  }
  return bad;
}

// pvu::encode_fields against encode on every exponent of the
// config's range and past it, each significand, both stickies and signs;
// returns the count of differing patterns
template <int N, int ES>
long long enc(const uint32_t* sig, long long m) {
  long long bad = 0;
  const int ms = (N - 2) * (1 << ES);
  for (int e = -ms - 9; e <= ms + 9; ++e)
    for (long long i = 0; i < m; ++i)
      for (uint32_t st = 0; st < 2; ++st)
        for (uint32_t sg = 0; sg < 2; ++sg)
          bad += pvu::encode_fields<N, ES>(sg, e, sig[i], st) !=
                 encode<N, ES>(sg, e, sig[i], st);
  return bad;
}

// f32 -> pattern both ways: ``direct`` computes each element's entry in
// place (posit::f32_to_posit), ``table`` reads it from the 512 entries
// posit::f32_fill writes, as the kernels do
template <int N, int ES>
void f32(const uint32_t* bits, uint32_t* direct, uint32_t* table, long long n) {
  posit::F32Entry lut[512];
  for (uint32_t e = 0; e < 256; ++e) posit::f32_fill<N, ES>(lut, e);
  const uint32_t mask = N < 32 ? (1u << N) - 1u : 0xFFFFFFFFu;
  for (long long i = 0; i < n; ++i) {
    direct[i] = posit::f32_to_posit<N, ES>(bits[i]);
    table[i] = posit::f32_round<N>(lut[bits[i] >> 23], bits[i]) & mask;
  }
}

}  // namespace

#define PVU_DISPATCH(CALL)                                   \
  if (nbits == 32 && es == 2) { CALL(32, 2); return 0; }     \
  if (nbits == 16 && es == 2) { CALL(16, 2); return 0; }     \
  if (nbits == 16 && es == 1) { CALL(16, 1); return 0; }     \
  if (nbits == 8 && es == 2) { CALL(8, 2); return 0; }       \
  if (nbits == 8 && es == 0) { CALL(8, 0); return 0; }       \
  return 1;

extern "C" int host_f32(int nbits, int es, const uint32_t* bits, uint32_t* direct,
                        uint32_t* table, long long n) {
#define CALL(N, ES) f32<N, ES>(bits, direct, table, n)
  PVU_DISPATCH(CALL)
#undef CALL
}

extern "C" long long host_encode(int nbits, int es, const uint32_t* sig, long long m) {
#define ENC(N, ES) if (nbits == N && es == ES) return enc<N, ES>(sig, m);
  ENC(32, 2) ENC(16, 2) ENC(16, 1) ENC(8, 2) ENC(8, 0)
#undef ENC
  return -1;
}


extern "C" int host_ew(int nbits, int es, int op, const uint32_t* a,
                       const uint32_t* b, uint32_t* o, long long n) {
#define CALL(N, ES) ew<N, ES>(op, a, b, o, n)
  PVU_DISPATCH(CALL)
#undef CALL
}

extern "C" int host_narrow(int nbits, int es, const uint32_t* p, float* o,
                           long long n) {
#define NARROW(N, ES) \
  if (nbits == N && es == ES) { for (long long i = 0; i < n; ++i) o[i] = posit::to_f32_narrow<N, ES>(p[i]); return 0; }
  NARROW(16, 2) NARROW(16, 1) NARROW(8, 2) NARROW(8, 0)
#undef NARROW
  return 1;
}

extern "C" long long host_place(int nbits, int es, const uint32_t* a, const uint32_t* b,
                                const int* delta, long long n) {
#define PLACE(N, ES) if (nbits == N && es == ES) return place<N, ES>(a, b, delta, n);
  PLACE(32, 2) PLACE(16, 2) PLACE(16, 1) PLACE(8, 2) PLACE(8, 0)
#undef PLACE
  return -1;
}

extern "C" int host_dot(int nbits, int es, const uint32_t* a, const uint32_t* b,
                        uint32_t* o, long long rows, long long len) {
#define CALL(N, ES) dot<N, ES>(a, b, o, rows, len)
  PVU_DISPATCH(CALL)
#undef CALL
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host check of csrc/pvu.cuh needs it")
    d = tmp_path_factory.mktemp("pvu_host")
    (d / "shim.cpp").write_text(_SHIM)
    so = d / "pvu_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I", str(_build.CSRC), "-o", str(so), str(d / "shim.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_ew.argtypes = [i, i, i, ptr, ptr, ptr, ll]
    lib.host_dot.argtypes = [i, i, ptr, ptr, ptr, ll, ll]
    lib.host_narrow.argtypes = [i, i, ptr, ptr, ll]
    lib.host_place.argtypes = [i, i, ptr, ptr, ptr, ll]
    lib.host_place.restype = ll
    lib.host_encode.argtypes = [i, i, ptr, ll]
    lib.host_encode.restype = ll
    lib.host_f32.argtypes = [i, i, ptr, ptr, ptr, ll]
    return lib


def _edges(cfg):
    return np.array([0, cfg.nar_pattern, cfg.maxpos_pattern, 1,
                     (-1) & cfg.mask, (-cfg.maxpos_pattern) & cfg.mask],
                    np.uint32)


def _pairs(cfg, seed=0):
    if cfg.nbits == 8:
        p = np.arange(256, dtype=np.uint32)
        a, b = np.meshgrid(p, p, indexing="ij")
        return a.ravel().copy(), b.ravel().copy()
    rng = np.random.default_rng(seed)
    e = _edges(cfg)
    ea, eb = np.meshgrid(e, e, indexing="ij")
    a = rng.integers(0, 2 ** cfg.nbits, 1 << 16, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** cfg.nbits, 1 << 16, dtype=np.uint64).astype(np.uint32)
    return (np.concatenate([ea.ravel(), a]), np.concatenate([eb.ravel(), b]))


def _plain(fn, a, b, cfg, **kw):
    out = fn(torch.from_numpy(a.astype(np.int64)),
             torch.from_numpy(b.astype(np.int64)), cfg, **kw)
    return signed_view(out).to(torch.int64).numpy().astype(np.uint32) & cfg.mask


_PLAIN = {"add": (P.vpadd, {}), "sub": (P.vpsub, {}), "mul": (P.vpmul, {}),
          "div_nr3": (P.vpdiv, {"mode": "nr3"}),
          "div_exact": (P.vpdiv, {"mode": "exact"})}


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c.name)
@pytest.mark.parametrize("op", OPS)
def test_header_elementwise_equals_plain(lib, cfg, op):
    a, b = _pairs(cfg)
    out = np.empty_like(a)
    rc = lib.host_ew(cfg.nbits, cfg.es, OPS.index(op), a.ctypes.data,
                     b.ctypes.data, out.ctypes.data, a.size)
    assert rc == 0
    fn, kw = _PLAIN[op]
    want = _plain(fn, a, b, cfg, **kw)
    bad = np.nonzero(out != want)[0][:5]
    assert bad.size == 0, [(int(a[i]), int(b[i]), int(out[i]), int(want[i]))
                           for i in bad]


@pytest.mark.parametrize("cfg", [POSIT8, POSIT16, POSIT32], ids=lambda c: c.name)
@pytest.mark.parametrize("length", [1, 16, 147, 4096, 4097, 9000])
def test_header_dot_equals_plain(lib, cfg, length):
    """Random patterns (NaR kept out of all but one row, zeros in one)
    and a bounded-spread row, across the 4096 tile boundary."""
    rng = np.random.default_rng(length)
    rows = 6
    a = rng.integers(0, 2 ** cfg.nbits, (rows, length), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** cfg.nbits, (rows, length), dtype=np.uint64).astype(np.uint32)
    a[a == cfg.nar_pattern] = 1
    b[b == cfg.nar_pattern] = 1
    a[1, -1] = cfg.nar_pattern                      # NaR in the last tile
    a[2] = 0                                        # an empty quire
    one = int(P.f32_to_posit(torch.tensor(1.0), cfg).to(torch.int64)) & cfg.mask
    a[3], b[3] = one, one                           # a sum of ones
    x = rng.uniform(1, 2, length) * rng.choice([-1, 1], length)
    a[4] = signed_view(P.f32_to_posit(torch.from_numpy(x.astype(np.float32)), cfg)
                       ).to(torch.int64).numpy() & cfg.mask
    out = np.empty(rows, np.uint32)
    rc = lib.host_dot(cfg.nbits, cfg.es, a.ctypes.data, b.ctypes.data,
                      out.ctypes.data, rows, length)
    assert rc == 0
    want = signed_view(P.vpdot(torch.from_numpy(a.astype(np.int64)),
                               torch.from_numpy(b.astype(np.int64)), cfg)
                       ).to(torch.int64).numpy() & cfg.mask
    np.testing.assert_array_equal(out, want.astype(np.uint32))


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c.name)
def test_place_add_equals_place_product(lib, cfg):
    """Every posit8 pair (2^16 seeded pairs with the edges in the wider
    configs), each at four alignment distances: the product's own
    exponent (d = 0), inside the window, past it (clamped at 95) and
    below it (clamped at 0)."""
    a, b = _pairs(cfg, seed=3)
    rng = np.random.default_rng(cfg.nbits)
    for lo, hi in ((0, 1), (1, 96), (96, 600), (-40, 0)):
        delta = rng.integers(lo, hi, a.size).astype(np.int32)
        assert lib.host_place(cfg.nbits, cfg.es, a.ctypes.data, b.ctypes.data,
                              delta.ctypes.data, a.size) == 0


@pytest.mark.parametrize("cfg", [POSIT8, POSIT8_E0, POSIT16, POSIT16_E1],
                         ids=lambda c: c.name)
def test_narrow_decode_equals_codec_on_every_pattern(lib, cfg):
    """``csrc/posit_narrow.cuh::to_f32_narrow`` (the decode inside the
    paged attention and posit-weight gemm kernels) gives the codec's f32
    bits for every pattern, NaR and zero included."""
    p = np.arange(1 << cfg.nbits, dtype=np.uint32)
    out = np.empty(p.size, np.float32)
    assert lib.host_narrow(cfg.nbits, cfg.es, p.ctypes.data, out.ctypes.data,
                           p.size) == 0
    want = posit_to_f32(to_storage(torch.from_numpy(p.astype(np.int64)),
                                   cfg.storage_dtype), cfg).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c.name)
def test_encode_fields_equals_posit_encode(lib, cfg):
    """``pvu::encode_fields`` (the kernels' encode on 32-bit words) gives
    the 64-bit stream encode's pattern for every exponent from 9 past each end
    of the config's range, both signs and stickies, and 2^14 significands:
    seeded ones with the hidden bit, without it, every run of trailing
    ones and zeros, and every significand of one or two set bits (the
    ties of the rounding)."""
    rng = np.random.default_rng(cfg.nbits * 10 + cfg.es)
    runs = [(1 << 32) - (1 << k) for k in range(33)] + [(1 << k) - 1 for k in range(33)]
    runs += [(1 << j) | (1 << k) for j in range(32) for k in range(j, 32)]
    sig = np.concatenate([
        rng.integers(0, 2 ** 31, 1 << 13, dtype=np.uint64) | (1 << 31),
        rng.integers(0, 2 ** 32, (1 << 14) - (1 << 13) - 2 * len(runs), dtype=np.uint64),
        np.array(runs, np.uint64), np.array(runs, np.uint64) | (1 << 31)]).astype(np.uint32)
    assert lib.host_encode(cfg.nbits, cfg.es, sig.ctypes.data, sig.size) == 0


def _f32_sweep(cfg):
    """Every f32 biased exponent with both signs and seeded mantissas
    (and mantissas 0, 1 and all ones); for posit8 and posit16 both f32
    neighbours of every midpoint between adjacent patterns, the midpoint
    itself where f32 holds it (the ties), on both signs; zeros,
    subnormals, +-inf and NaNs."""
    rng = np.random.default_rng(cfg.nbits * 10 + cfg.es + 1)
    e8 = np.arange(512, dtype=np.uint32)[:, None] << 23
    man = np.concatenate([rng.integers(0, 1 << 23, (512, 61), dtype=np.uint64).astype(np.uint32),
                          np.tile(np.array([0, 1, 2, (1 << 22), (1 << 23) - 1], np.uint32),
                                  (512, 1))], axis=1)
    parts = [(e8 | man).ravel()]
    if cfg.nbits <= 16:
        pats = np.arange(1, 1 << (cfg.nbits - 1), dtype=np.int64)       # minpos..maxpos
        v = posit_to_f32(to_storage(torch.from_numpy(pats), cfg.storage_dtype),
                         cfg).numpy().astype(np.float64)
        mid = ((v[:-1] + v[1:]) / 2).astype(np.float32)
        near = np.concatenate([np.nextafter(mid, np.float32(0)), mid,
                               np.nextafter(mid, np.float32(np.inf))])
        parts += [near.view(np.uint32), (-near).view(np.uint32)]
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-45, -1e-45,
                        1.1754942e-38, -1.1754942e-38, 5.9e-39, 3.4028235e38,
                        -3.4028235e38], np.float32).view(np.uint32)
    parts += [special, np.array([0x7F800001, 0xFFC00001, 0x7FFFFFFF, 0x00000001,
                                 0x807FFFFF, 0x00400000], np.uint32)]
    return np.concatenate(parts)


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c.name)
def test_f32_encode_equals_codec(lib, cfg):
    """The quantizers' encode (``csrc/posit.cuh``: a table entry per sign
    and biased exponent and one 32-bit rounding) gives
    ``core.convert.f32_to_posit``'s pattern on the whole sweep, both with
    the entry computed in place (``f32_to_posit``) and read from the
    512-entry table ``f32_fill`` writes, as the kernels read it."""
    bits = _f32_sweep(cfg)
    direct, table = np.empty_like(bits), np.empty_like(bits)
    assert lib.host_f32(cfg.nbits, cfg.es, bits.ctypes.data, direct.ctypes.data,
                        table.ctypes.data, bits.size) == 0
    want = signed_view(f32_to_posit(torch.from_numpy(bits.view(np.float32).copy()), cfg)
                       ).to(torch.int64).numpy().astype(np.uint32) & cfg.mask
    for got in (direct, table):
        bad = np.nonzero(got != want)[0][:5]
        assert bad.size == 0, [(hex(int(bits[i])), int(got[i]), int(want[i])) for i in bad]
