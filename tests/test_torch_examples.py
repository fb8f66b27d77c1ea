"""The six examples on the port (``repro_torch.examples``) on the CPU.

Each example's ``run("cpu")`` holds its own self-check (``check``): the
reference's assertions, at the reference's configs, seeds and sizes.
Two run fewer steps than the reference's, where their assertion still
holds: gradient_compression 90 of 120 steps a run, train_lm 70 of 300
(each takes 30 s to 3 min on the CPU at the full count).
elastic_restart's two ranks run in ``tests/test_torch_train_elastic.py``'s
spawn (``train_lanes.rank_elastic``).

Where the reference's example function needs no Pallas interpret run
(``conv4x4_posit``, and quickstart's posit32 ISA table on core ops), the
port's is held to it bit for bit on the same numpy inputs; the
reference's example files are loaded by path.
"""
import functools
import importlib
import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parent.parent
NAMES = ("quickstart", "posit_convolution", "serve_posit_kv", "gradient_compression",
         "train_lm", "elastic_restart")
STEPS = {"gradient_compression": 90, "train_lm": 70}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the examples' small ops gain nothing from more,
    and the other workers keep their cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _example(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


def _reference(name):
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _result(name):
    mod = _example(name)
    return mod.run("cpu", steps=STEPS[name]) if name in STEPS else mod.run("cpu")


@pytest.mark.parametrize("name", ["quickstart", "posit_convolution", "serve_posit_kv",
                                  "gradient_compression", "train_lm"])
def test_example_self_check_holds_on_cpu(name):
    _example(name).check(_result(name))


def test_example_outputs_on_cpu():
    """What the self-checks do not cover: the codec's error, the byte
    savings, the paged layout's blocks, the wire's 4x."""
    qs = _result("quickstart")
    assert qs["codec_dtype"] == "torch.uint16" and qs["codec_rel_err"] < 1e-3
    assert qs["vdiv_size"] == 64 * 128
    kv = _result("serve_posit_kv")
    assert kv["rep_f32"]["bytes"] > 1.9 * kv["rep_q"]["bytes"]
    assert 0 < kv["peak_blocks"] < kv["n_blocks"]
    gc = _result("gradient_compression")
    assert gc["bytes_f32"] == 4 * gc["bytes_p8"]


def test_quickstart_isa_table_matches_reference():
    """Sections 1-3 on posit32: conversion, the five ops and the 500
    random vpmul pairs, bit for bit against the reference's core ops."""
    ref = _reference("quickstart")
    got = _example("quickstart").isa_table("cpu")
    cfg = ref.POSIT32
    enc = jax.jit(lambda x: ref.f32_to_posit(x, cfg))
    x = enc(jnp.asarray(_example("quickstart").X, jnp.float32))
    np.testing.assert_array_equal(got["x"], np.asarray(x).astype(np.uint32))
    np.testing.assert_array_equal(got["back"], np.asarray(ref.posit_to_f32(x, cfg)))
    for name, width in (("posit16_roundtrip", ref.POSIT16), ("posit8_roundtrip", ref.POSIT8)):
        want = np.asarray(ref.quant_dequant(jnp.asarray(_example("quickstart").X,
                                                        jnp.float32), width))
        np.testing.assert_array_equal(got[name], want)
    qs = _example("quickstart")
    a = enc(jnp.asarray(qs.A, jnp.float32))
    b = enc(jnp.asarray(qs.B, jnp.float32))
    for name in ("vpadd", "vpsub", "vpmul", "vpdiv"):
        fn = jax.jit(lambda p, q, f=getattr(ref, name): f(p, q, cfg))
        np.testing.assert_array_equal(got[name], np.asarray(fn(a, b)).astype(np.uint32),
                                      err_msg=name)
    dot = jax.jit(lambda p, q: ref.vpdot(p, q, cfg))(a[None, :], b[None, :])
    np.testing.assert_array_equal(got["vpdot"], np.asarray(dot).astype(np.uint32))
    rng = np.random.default_rng(0)
    pa = rng.integers(0, 2 ** 32, 500, dtype=np.uint32)
    pb = rng.integers(0, 2 ** 32, 500, dtype=np.uint32)
    want = np.asarray(jax.jit(lambda p, q: ref.vpmul(p, q, cfg))(jnp.asarray(pa),
                                                                 jnp.asarray(pb)))
    from repro_torch.core.posit import POSIT32, vpmul
    mine = vpmul(torch.from_numpy(pa.astype(np.int64)), torch.from_numpy(pb.astype(np.int64)),
                 POSIT32).numpy().astype(np.uint32)
    np.testing.assert_array_equal(mine, want.astype(np.uint32))


def test_conv4x4_posit_matches_reference():
    """The port's ``conv4x4_posit`` (codec, ``ops.dot``) against the
    reference's (core ``f32_to_posit`` and ``vpdot``) on the example's
    seeded inputs: patterns and values bit for bit."""
    ref = _reference("posit_convolution")
    mine = _example("posit_convolution")
    image, kernel = mine.inputs()
    want_f, want_p = ref.conv4x4_posit(image, kernel)
    got_f, got_p = mine.conv4x4_posit(image, kernel, "cpu")
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_f, want_f)


@pytest.mark.parametrize("name", NAMES)
def test_example_defaults_to_cuda_and_raises_without_a_gpu(name, monkeypatch):
    mod = _example(name)
    assert inspect.signature(mod.run).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mod.run()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mod.main([])
