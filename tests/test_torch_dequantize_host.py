"""The codec's dequantize itself, run on the host, and the two linear decode
reads that call it.

``csrc/posit_codec.cu`` compiles with ``g++`` against the CTA emulation of
the CUDA runtime in ``cuda_host_stub.py`` (shared with
``test_torch_quantize_host.py``), and ``posit_dequantize`` runs on CPU
tensors.  Its outputs must equal ``posit_codec.dequantize_many_plain`` bit
for bit (``int32`` views, NaR included): all five configs, f32 and
bf16-rounded outputs, a ragged head and tail, source and output views at
element offsets 1-7, ``n`` below one vector and zero, a persistent grid
striding over several passes, 1, 2 and 4 jobs of unequal lengths (an empty
one among them), and every posit8 and posit16 pattern.  On a subset,
against the reference's Pallas ``dequantize_2d`` in interpret mode and its
``posit_to_f32(x).astype(bfloat16)``.

On the CPU (the wrappers' plain path): ``dequantize_many_plain`` with
``round_to=bfloat16`` equals the chain the linear decode read ran before
(decode, cast to bf16, cast back) bit for bit; ``layers.decode_attention``
and ``transformer._decode_attn_mla`` on posit16 and posit8 caches equal
the reference's within f32 summation order, make one ``dequantize_many``
call and no other dequantize, and the dense read's values are bit for bit
those of the cache decoded first.  Skipped where ``g++`` is missing (the
host-run tests only).
"""
import ctypes
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cuda_host_stub
from repro import configs as RCFG
from repro.core import convert as RCV
from repro.core import types as RT
from repro.kernels import posit_codec as RK
from repro.models import layers as RL
from repro.models import transformer as RTF
from repro_torch import configs as TCFG
from repro_torch.core.types import CONFIGS, POSIT8, POSIT16, signed_view
from repro_torch.kernels import _build
from repro_torch.kernels import posit_codec as C
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.weights import params_from_jax

NP = {8: np.uint8, 16: np.uint16, 32: np.uint32}
REF_CFG = {"posit8e2": RT.POSIT8, "posit16e2": RT.POSIT16, "posit32e2": RT.POSIT32,
           "posit16e1": RT.POSIT16_E1, "posit8e0": RT.POSIT8_E0}
MAX_JOBS = 4
MODES = [None, torch.bfloat16]
MODE_IDS = ["f32", "bf16"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are many small int64 ops: under the suite's
    parallel workers torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def codec(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host run of the kernel needs it")
    d = tmp_path_factory.mktemp("dequantize_host")
    (d / "cuda_runtime.h").write_text(cuda_host_stub.STUB)
    lib = cuda_host_stub.build(gxx, d, _build.CSRC, "posit_codec")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.posit_dequantize.argtypes = [I, I, I, I, P, P, P, I, P]
    lib.posit_dequantize.restype = I
    return lib


def _chunk(cfg):
    """Elements of one CTA's trip: 256 lanes, 4 units of four patterns each
    (2 of posit32)."""
    return 256 * 4 * (2 if cfg.nbits == 32 else 4)


def _cfg(name):
    return next(c for c in CONFIGS if c.name == name)


def _i32(t):
    return t.view(torch.int32)


def _pats(cfg, n, seed):
    """Seeded random patterns, every bit pattern possible, NaR and zero up
    front."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** cfg.nbits, n, dtype=np.uint64).astype(NP[cfg.nbits])
    x[:2] = [1 << (cfg.nbits - 1), 0][:min(n, 2)]
    return torch.from_numpy(x.copy())


def _run(codec, cfg, srcs, outs, round_to, sms=1):
    """The C entry on leaves ``srcs`` into f32 buffers ``outs``."""
    n = len(srcs)
    return codec.posit_dequantize(
        cfg.nbits, cfg.es, int(round_to is not None), n,
        (ctypes.c_void_p * n)(*[s.data_ptr() for s in srcs]),
        (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs]),
        (ctypes.c_longlong * n)(*[s.numel() for s in srcs]), sms, None)


def _case(codec, cfg, leaves, round_to, offs=None, sms=1):
    """The kernel on ``leaves``, each copied into a buffer at source element
    offset ``offs[j][0]`` and decoded into a buffer at output element
    offset ``offs[j][1]``, against ``dequantize_many_plain``; nothing
    outside the outputs changes."""
    offs = offs or [(0, 0)] * len(leaves)
    srcs, bufs, outs = [], [], []
    for p, (so, oo) in zip(leaves, offs):
        sb = torch.zeros(p.numel() + so + 3, dtype=cfg.storage_dtype)
        sb[so:so + p.numel()] = p
        srcs.append(sb[so:so + p.numel()])
        ob = torch.full((p.numel() + oo + 5,), -7.25)
        bufs.append((ob, oo))
        outs.append(ob[oo:oo + p.numel()])
    assert _run(codec, cfg, srcs, outs, round_to, sms) == 0
    for p, got, (ob, oo) in zip(leaves, outs, bufs):
        want = C.dequantize_many_plain([p], cfg, round_to)[0]
        bad = torch.nonzero(_i32(got) != _i32(want))[:5, 0].tolist()
        assert not bad, [(int(signed_view(p)[i]), hex(int(_i32(got)[i])),
                          hex(int(_i32(want)[i]))) for i in bad]
        assert (ob[:oo] == -7.25).all() and (ob[oo + p.numel():] == -7.25).all()


@pytest.mark.parametrize("round_to", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_dequantize_kernel_equals_plain(codec, cfg, round_to):
    """1 531 patterns (a ragged tail after the vectors) at every source
    offset from 0 to 7 elements (a ragged head) and output offsets that
    leave the output off the source's vectors; lengths below one vector,
    one vector and zero."""
    p = _pats(cfg, 1531, 1)
    for so in range(8):
        for oo in (0, 1, 3) if so else range(8):
            _case(codec, cfg, [p], round_to, [(so, oo)])
    for n in (1, 2, 3, 15, 16, 17):
        for off in ((0, 0), (5, 5), (3, 0)):
            _case(codec, cfg, [_pats(cfg, n, n)], round_to, [off])
    out = torch.full((4,), 3.0)
    assert _run(codec, cfg, [p[:0]], [out], round_to) == 0
    assert (out == 3.0).all()


@pytest.mark.parametrize("round_to", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_dequantize_kernel_grid_stride(codec, cfg, round_to):
    """One SM's persistent grid (8 CTAs) over 2.5 passes of its chunks,
    aligned and at odd offsets."""
    per_pass = 8 * _chunk(cfg)
    p = _pats(cfg, per_pass * 5 // 2 + 7, 2)
    _case(codec, cfg, [p], round_to)
    _case(codec, cfg, [p], round_to, [(1, 2)])


@pytest.mark.parametrize("round_to", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("cfg", [POSIT16, POSIT8, _cfg("posit32e2")], ids=lambda c: c.name)
def test_dequantize_kernel_jobs(codec, cfg, round_to):
    """1, 2 and 4 jobs of unequal lengths in one launch (K and V; a latent
    and its RoPE key; an empty job and one below a vector among four), on
    one SM's grid so that CTAs stride across the jobs' chunks, some leaves
    at odd offsets."""
    chunk = _chunk(cfg)
    _case(codec, cfg, [_pats(cfg, 2 * chunk + 5, 3)], round_to)
    _case(codec, cfg, [_pats(cfg, chunk + 9, 4), _pats(cfg, chunk + 9, 5)], round_to,
          [(0, 0), (2, 1)])
    _case(codec, cfg, [_pats(cfg, 3 * chunk, 6), _pats(cfg, chunk // 8 + 3, 7)], round_to)
    lens = (2 * chunk + 1, 0, 3, 3 * chunk // 2)
    assert len(lens) == MAX_JOBS
    _case(codec, cfg, [_pats(cfg, n, 8 + i) for i, n in enumerate(lens)], round_to,
          [(0, 0), (0, 0), (1, 0), (3, 3)])


@pytest.mark.parametrize("round_to", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("name", ["posit8e2", "posit8e0", "posit16e2", "posit16e1"])
def test_dequantize_kernel_every_pattern(codec, name, round_to):
    """Every posit8 and posit16 pattern, NaR included, as one leaf and split
    into two jobs."""
    cfg = _cfg(name)
    p = torch.arange(1 << cfg.nbits, dtype=torch.int64).to(cfg.storage_dtype)
    _case(codec, cfg, [p], round_to, sms=4)
    h = p.numel() // 2 + 5
    _case(codec, cfg, [p[:h].clone(), p[h:].clone()], round_to, sms=4)


def test_dequantize_kernel_refuses_bad_tables(codec):
    """0 or more than 4 jobs are invalid values; a posit16 source at an odd
    byte or an output off a float is a misaligned address."""
    p = _pats(POSIT16, 64, 9)
    out = torch.empty(65)
    assert _run(codec, POSIT16, [p] * (MAX_JOBS + 1), [out] * (MAX_JOBS + 1), None) == 1
    n0 = codec.posit_dequantize(16, 2, 0, 0, None, None, None, 1, None)
    assert n0 == 1
    raw = torch.zeros(200, dtype=torch.uint8)
    odd = ctypes.c_void_p(raw.data_ptr() + 1)
    assert codec.posit_dequantize(
        16, 2, 0, 1, (ctypes.c_void_p * 1)(odd),
        (ctypes.c_void_p * 1)(out.data_ptr()), (ctypes.c_longlong * 1)(8), 1, None) == 716
    assert codec.posit_dequantize(
        16, 2, 0, 1, (ctypes.c_void_p * 1)(p.data_ptr()),
        (ctypes.c_void_p * 1)(raw.data_ptr() + 2), (ctypes.c_longlong * 1)(8), 1,
        None) == 716


@pytest.mark.parametrize("name", sorted(REF_CFG))
def test_dequantize_kernel_equals_pallas(codec, name):
    """A subset against the reference: one (8, 100) block through the
    Pallas ``dequantize_2d`` in interpret mode (f32 out), and through
    ``posit_to_f32(x).astype(bfloat16)`` widened (bf16 out)."""
    cfg = _cfg(name)
    p = _pats(cfg, 800, 10)
    host = signed_view(p).numpy().view(NP[cfg.nbits]).reshape(8, 100)
    for round_to in MODES:
        out = torch.empty(800)
        assert _run(codec, cfg, [p], [out], round_to) == 0
        if round_to is None:
            want = np.asarray(RK.dequantize_2d(jnp.asarray(host), REF_CFG[name],
                                               interpret=True))
        else:
            want = np.asarray(RCV.posit_to_f32(jnp.asarray(host), REF_CFG[name])
                              .astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                      want.reshape(-1).view(np.uint32))


# ---------------------------------------------------------------------------
# The plain path: the rounding, and the two linear decode reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_plain_bf16_rounding_equals_old_chain_and_reference(cfg):
    """``dequantize_many_plain(..., round_to=bfloat16)`` is the chain the
    linear read ran before, ``dequantize_plain(x).to(bfloat16).to(float32)``,
    bit for bit on every value but NaR, where both are NaN; and the
    reference's ``posit_to_f32(x).astype(bfloat16)`` widened bit for bit,
    NaR included.  Every posit8/16 pattern, seeded posit32 ones."""
    p = torch.arange(1 << cfg.nbits, dtype=torch.int64).to(cfg.storage_dtype) \
        if cfg.nbits < 32 else _pats(cfg, 1 << 16, 11)
    got = C.dequantize_many_plain([p], cfg, torch.bfloat16)[0]
    old = C.dequantize_plain(p, cfg).to(torch.bfloat16).to(torch.float32)
    nan = torch.isnan(old)
    assert torch.equal(nan, torch.isnan(got))
    assert torch.equal(_i32(got)[~nan], _i32(old)[~nan])
    host = signed_view(p).numpy().view(NP[cfg.nbits])
    ref = np.asarray(RCV.posit_to_f32(jnp.asarray(host), REF_CFG[cfg.name])
                     .astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))
    assert torch.equal(_i32(C.dequantize_many_plain([p], cfg)[0]),
                       _i32(C.dequantize_plain(p, cfg)))
    with pytest.raises(ValueError, match="round_to"):
        C.dequantize_many_plain([p], cfg, torch.float16)


class _Count:
    """Counts the calls of ``posit_codec.dequantize_many`` and
    ``posit_codec.dequantize`` while it is installed."""

    def __init__(self, monkeypatch):
        self.many = self.one = 0
        many, one = C.dequantize_many, C.dequantize

        def count_many(*a, **kw):
            self.many += 1
            return many(*a, **kw)

        def count_one(*a, **kw):
            self.one += 1
            return one(*a, **kw)

        monkeypatch.setattr(C, "dequantize_many", count_many)
        monkeypatch.setattr(C, "dequantize", count_one)


def _dense_case(kv, seed):
    """(B, 1, H, D) queries and (B, T, G, D) posit caches of random values,
    ragged lengths and starts (an all-masked row)."""
    rng = np.random.default_rng(seed)
    b, t, g, h, d = 3, 20, 2, 4, 16
    cfg = L.pcfg(kv)
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    k = C.quantize_plain(torch.from_numpy(rng.normal(size=(b, t, g, d)).astype(np.float32)),
                         cfg)
    v = C.quantize_plain(torch.from_numpy(rng.normal(size=(b, t, g, d)).astype(np.float32)),
                         cfg)
    cache_len = np.array([20, 13, 7], np.int32)
    start = np.array([0, 4, 7], np.int32)
    return q, k, v, cache_len, start


def _np_pats(t, cfg):
    return signed_view(t).numpy().view(NP[cfg.nbits])


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
@pytest.mark.parametrize("kv", ["posit16", "posit8"])
@pytest.mark.parametrize("lane", ["dense", "ring", "window"])
def test_decode_attention_posit_read_equals_reference(monkeypatch, kv, compute, lane):
    """``layers.decode_attention`` on posit caches against the reference's
    (f32 summation order apart: atol = rtol = 1e-5); one
    ``dequantize_many`` call for both leaves and no other dequantize; and
    bit for bit the output of the same call on the caches decoded first
    (the old chain's values: decode, cast to the compute dtype, widen)."""
    q, k, v, cache_len, start = _dense_case(kv, 12)
    rc = RCFG.get_config("phi3-medium-14b").reduced(compute_dtype=compute)
    tc = TCFG.get_config("phi3-medium-14b").reduced(compute_dtype=compute)
    kw = dict(ring=lane == "ring", window=8 if lane == "window" else 0)
    ref = np.asarray(RL.decode_attention(
        jnp.asarray(q), jnp.asarray(_np_pats(k, L.pcfg(kv))),
        jnp.asarray(_np_pats(v, L.pcfg(kv))), jnp.asarray(cache_len), cfg=rc, kv_posit=kv,
        start=jnp.asarray(start), **kw))
    n = _Count(monkeypatch)
    got = L.decode_attention(torch.from_numpy(q), k, v, torch.from_numpy(cache_len), cfg=tc,
                             kv_posit=kv, start=torch.from_numpy(start), **kw)
    assert (n.many, n.one) == (1, 0)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    pc = L.pcfg(kv)
    pre = L.decode_attention(torch.from_numpy(q), C.dequantize_plain(k, pc),
                             C.dequantize_plain(v, pc), torch.from_numpy(cache_len), cfg=tc,
                             start=torch.from_numpy(start), **kw)
    assert torch.equal(_i32(got), _i32(pre))


_MLA = {}


def _mla_params(kv):
    if kv not in _MLA:
        rc = RCFG.get_config("minicpm3-4b").reduced(compute_dtype="float32", kv_posit=kv)
        tc = TCFG.get_config("minicpm3-4b").reduced(compute_dtype="float32", kv_posit=kv)
        rp = RTF.init_params(jax.random.PRNGKey(0), rc)
        tp = params_from_jax(jax.tree.map(np.asarray, rp), tc, device="cpu")
        _MLA[kv] = (rc, tc, jax.tree.map(lambda a: a[0], rp["layers"]), tp["layers"][0])
    return _MLA[kv]


@pytest.mark.parametrize("kv", ["posit16", "posit8"])
def test_decode_attn_mla_posit_read_equals_reference(monkeypatch, kv):
    """``transformer._decode_attn_mla`` (the MLA linear lane's layer) on
    posit latent and RoPE caches against the reference's, at one layer of
    the reduced minicpm3 (logit tolerance of the model parity tests,
    atol = rtol = 1e-4): one ``dequantize_many`` call for both leaves and
    no other dequantize."""
    rc, tc, rl, tl = _mla_params(kv)
    rng = np.random.default_rng(13)
    b, t, pos = 3, 16, 9
    pc = L.pcfg(kv)
    c = C.quantize_plain(torch.from_numpy(
        rng.normal(size=(b, t, tc.kv_lora_rank)).astype(np.float32)), pc)
    r = C.quantize_plain(torch.from_numpy(
        rng.normal(size=(b, t, tc.qk_rope_dim)).astype(np.float32)), pc)
    x = rng.normal(size=(b, 1, tc.d_model)).astype(np.float32)
    lens = np.array([9, 5, 0], np.int32)
    ref, _, _ = RTF._decode_attn_mla(
        rl["attn"], jnp.asarray(x), jnp.asarray(_np_pats(c, pc)),
        jnp.asarray(_np_pats(r, pc)), pos, jnp.asarray(lens), rc)
    n = _Count(monkeypatch)
    slots = L.linear_write_slots(b, t, pos, ring=False, device="cpu")
    got = T._decode_attn_mla(tl["attn"], torch.from_numpy(x), c, r, pos,
                             torch.from_numpy(lens), slots, tc)
    assert (n.many, n.one) == (1, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_dequantize_many_checks_round_to_and_jobs():
    """The wrapper takes ``round_to`` None or bf16 only, and its CPU path
    keeps shapes and returns one f32 tensor a leaf."""
    p = _pats(POSIT16, 24, 14).view(2, 3, 4)
    outs = C.dequantize_many([p, p[0]], POSIT16, torch.bfloat16)
    assert [tuple(o.shape) for o in outs] == [(2, 3, 4), (3, 4)]
    assert all(o.dtype == torch.float32 for o in outs)
    with pytest.raises(ValueError, match="round_to"):
        C.dequantize_many([p], POSIT16, torch.float32)
