"""The port's optimizer and train step against the reference.

``adamw.update`` on the same parameters and gradients, with and without
posit16 moments, two steps (the second decodes the first's moment):
parameters and ``v`` within 1e-6 of each leaf's largest magnitude, the
stored ``m`` patterns equal to the port's own codec of its f32 ``m_new``
bit for bit and within one pattern step of the reference's;
``cosine_schedule`` within 1e-6 relative (XLA's f32 cosine and ATen's
differ in the last bit).  ``make_train_step`` for 3 steps with
``grad_accum`` 2 on the reference ``Pipeline``'s batches against the
reference's jitted step: the losses within rel 1e-5, the parameters and
``v`` within 1e-5 of each leaf's largest magnitude, ``m`` as stated
there.  Then mirrors of ``tests/test_system.py``'s train tests and of
``tests/test_models_smoke.py::test_reduced_train_step`` on the port
alone.  The trees here use sorted keys and no layer lists, so both
packages walk their leaves in the same order.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as RCFG
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import Pipeline as RPipeline
from repro.models import get_family as ref_family
from repro.optim import adamw as ref_adamw
from repro.runtime import train_loop as ref_train_loop
from repro_torch import configs as TCFG
from repro_torch import tree as TT
from repro_torch.core.convert import f32_to_posit, posit_to_f32
from repro_torch.core.types import POSIT16, signed_view
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models import build, get_family
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop
from repro_torch.weights import params_from_jax, params_to_jax


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, scale=1.0):
    return {"a": {"w": (scale * rng.standard_normal((8, 16))).astype(np.float32)},
            "b": (scale * rng.standard_normal(16)).astype(np.float32),
            "e": (scale * rng.standard_normal((3, 4, 5))).astype(np.float32)}


def _t(tree):
    return TT.tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)


def _pattern_steps(got, want):
    """|signed pattern difference| (posit16 order is signed-int order)."""
    g = signed_view(got).numpy().astype(np.int64)
    w = np.asarray(want).view(np.int16).astype(np.int64)
    return np.abs(g - w)


def _close(got, want, rtol=1e-6):
    """Within ``rtol`` of the leaf's largest magnitude: the clip scale
    comes from a global norm summed in another order, and elements near
    zero cancel in ``p * (1 - lr * wd) - lr * step``."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got.numpy() - want).max()) <= rtol * scale


@pytest.mark.parametrize("posit_moments", [False, True])
def test_adamw_update_matches_reference(posit_moments, monkeypatch):
    rng = np.random.default_rng(0)
    cfg = dict(lr=1e-2, weight_decay=0.1, posit_moments=posit_moments)
    params = _tree(rng)
    grads = [_tree(rng, 0.3), _tree(rng, 3.0)]      # the second one clips
    rcfg, tcfg = ref_adamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    r_upd = jax.jit(lambda g, s, p, lr: ref_adamw.update(g, s, p, rcfg, lr))
    rp = jax.tree.map(jnp.asarray, params)
    rs = ref_adamw.init(rp, rcfg)
    tp = _t(params)
    ts = adamw.init(tp, tcfg)
    for i, g in enumerate(grads):
        lr_scale = 0.5 + i
        rp, rs, rm = r_upd(jax.tree.map(jnp.asarray, g), rs, rp, jnp.float32(lr_scale))
        m_new = []

        def capture(x, quantize=adamw.quantize_m):
            m_new.append(x.clone())
            return quantize(x)

        c = adamw.coefficients(_t(g), ts, tcfg, torch.tensor(lr_scale))
        with monkeypatch.context() as mp:
            mp.setattr(adamw, "quantize_m", capture)
            new_m = [adamw.update_leaf(p, gg, m, v, c, tcfg)
                     for p, gg, m, v in zip(TT.leaves(tp), TT.leaves(_t(g)),
                                            TT.leaves(ts["m"]), TT.leaves(ts["v"]))]
        ts = {"m": TT.unflatten(ts["m"], new_m), "v": ts["v"], "count": c.count}
        assert int(ts["count"]) == int(rs["count"]) == i + 1
        np.testing.assert_allclose(float(c.grad_norm), float(rm["grad_norm"]), rtol=1e-6)
        for got, want in zip(TT.leaves(tp) + TT.leaves(ts["v"]),
                             jax.tree.leaves(rp) + jax.tree.leaves(rs["v"])):
            _close(got, want)
        for j, (got, want) in enumerate(zip(TT.leaves(ts["m"]), jax.tree.leaves(rs["m"]))):
            if posit_moments:
                assert got.dtype == torch.uint16
                assert torch.equal(signed_view(got), signed_view(f32_to_posit(m_new[j],
                                                                              POSIT16)))
                assert _pattern_steps(got, want).max() <= 1
            else:
                _close(got, want)


def test_adamw_update_tree_form_equals_leaf_form():
    """``update`` over a tree runs ``update_leaf`` on each leaf."""
    rng = np.random.default_rng(1)
    cfg = adamw.AdamWConfig(lr=1e-2, posit_moments=True)
    params, g = _tree(rng), _tree(rng)
    outs = []
    for tree_form in (True, False):
        tp = _t(params)
        st = adamw.init(tp, cfg)
        if tree_form:
            tp, st, _ = adamw.update(_t(g), st, tp, cfg, torch.tensor(0.7))
            outs.append(TT.leaves(tp) + TT.leaves(st["m"]) + TT.leaves(st["v"]))
        else:
            c = adamw.coefficients(_t(g), st, cfg, torch.tensor(0.7))
            ms = [adamw.update_leaf(p, gg, m, v, c, cfg) for p, gg, m, v in zip(
                TT.leaves(tp), TT.leaves(_t(g)), TT.leaves(st["m"]), TT.leaves(st["v"]))]
            outs.append(TT.leaves(tp) + ms + TT.leaves(st["v"]))
    for a, b in zip(*outs):
        assert torch.equal(signed_view(a), signed_view(b))


def test_cosine_schedule_matches_reference():
    steps = np.array([0, 1, 5, 99, 100, 101, 500, 9_999, 10_000, 12_000], np.int32)
    for kw in ({}, {"warmup": 10, "total": 60}, {"base_lr": 2.0, "min_frac": 0.0}):
        want = np.asarray(jax.jit(lambda s: ref_adamw.cosine_schedule(s, **kw))(
            jnp.asarray(steps)))
        got = adamw.cosine_schedule(torch.from_numpy(steps), **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_make_train_step_matches_reference_with_grad_accum():
    """Three steps of the reduced gemma-7b (tied head) with ``grad_accum``
    2 and posit16 moments, on the reference pipeline's batches."""
    rc = dataclasses.replace(RCFG.get_config("gemma-7b").reduced(compute_dtype="float32"),
                             grad_accum=2)
    tc = dataclasses.replace(TCFG.get_config("gemma-7b").reduced(compute_dtype="float32"),
                             grad_accum=2)
    ocfg = dict(lr=1e-2, posit_moments=True)
    rp = ref_family(rc).init_params(jax.random.PRNGKey(0), rc)
    tp = params_from_jax(jax.tree.map(np.asarray, rp), tc, device="cpu")
    ropt = ref_adamw.AdamWConfig(**ocfg)
    rs = ref_adamw.init(rp, ropt)
    topt = adamw.AdamWConfig(**ocfg)
    ts = adamw.init(tp, topt)
    r_step = jax.jit(ref_train_loop.make_train_step(rc, ropt, total_steps=4))
    t_step = train_loop.make_train_step(tc, topt, total_steps=4)
    pipe = RPipeline(RDataConfig(seed=5), rc, global_batch=4, seq_len=32)
    for step in range(3):
        batch = pipe.batch_at(step)
        rp, rs, rm = r_step(rp, rs, batch, jnp.asarray(step, jnp.int32))
        tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        tp, ts, tm = t_step(tp, ts, tbatch, step)
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= 1e-5 * abs(float(rm["loss"]))
        np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]),
                                   rtol=1e-5)
    assert all(p.grad is None and not p.requires_grad for p in TT.leaves(tp))
    got = {"p": params_to_jax(tp), "v": params_to_jax(ts["v"]), "m": params_to_jax(ts["m"])}
    for key, want_tree in (("p", rp), ("v", rs["v"]), ("m", rs["m"])):
        for path, want in jax.tree_util.tree_flatten_with_path(want_tree)[0]:
            g = got[key]
            for k in path:
                g = g[k.key]
            want = np.asarray(want)
            if key == "m":
                # patterns of tiny moments: 99 % equal, the rest within
                # 1e-3 of the leaf's largest |m| once decoded
                d = np.abs(g.view(np.int16).astype(np.int64)
                           - want.view(np.int16).astype(np.int64))
                assert (d == 0).mean() >= 0.99, (path, (d == 0).mean())
                g, want = (posit_to_f32(torch.from_numpy(np.array(a).view(np.int16)).view(
                    torch.uint16), POSIT16).numpy() for a in (g, want))
                scale = max(float(np.abs(want).max()), 1e-30)
                assert float(np.abs(g - want).max()) <= 1e-3 * scale, (key, path)
            else:
                scale = max(float(np.abs(want).max()), 1e-30)
                assert float(np.abs(g - want).max()) <= 1e-5 * scale, (key, path)


def test_make_train_step_refuses_the_pod_compressed_step():
    cfg = TCFG.get_config("gemma-7b").reduced(compute_dtype="float32")
    assert cfg.grad_compress == "posit16"
    with pytest.raises(NotImplementedError, match="pod mesh"):
        train_loop.make_train_step(cfg, adamw.AdamWConfig(), n_pods=2, compressed=True)
    train_loop.make_train_step(cfg, adamw.AdamWConfig(), n_pods=1, compressed=True)


# ---------------------------------------------------------------------------
# Mirrors of tests/test_system.py's train tests on the port
# ---------------------------------------------------------------------------

def _init(cfg, seed):
    return get_family(cfg).init_params(cfg, seed=seed, device="cpu", dtype=torch.float32)


def test_train_step_improves_loss():
    """A reduced model learns on the structured synthetic stream."""
    cfg = TCFG.get_config("internvl2-1b").reduced(compute_dtype="float32",
                                                  n_visual_tokens=0)
    opt_cfg = adamw.AdamWConfig(lr=2e-3, weight_decay=0.0)
    pipe = Pipeline(DataConfig(seed=2), cfg, global_batch=8, seq_len=64, device="cpu")
    params = _init(cfg, 0)
    opt = adamw.init(params, opt_cfg)
    step = train_loop.make_train_step(cfg, opt_cfg, total_steps=60)
    losses = []
    for i in range(60):
        params, opt, m = step(params, opt, pipe.batch_at(i), i)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.85, (losses[0], losses[-1])
    assert np.isfinite(losses).all()


def test_posit_moments_train_step_close_to_f32():
    cfg = TCFG.get_config("whisper-tiny").reduced(compute_dtype="float32")
    pipe = Pipeline(DataConfig(seed=3), cfg, global_batch=2, seq_len=32, device="cpu")
    outs = {}
    for name, pm in (("f32", False), ("posit", True)):
        opt_cfg = adamw.AdamWConfig(lr=1e-3, posit_moments=pm, weight_decay=0.0)
        p = _init(cfg, 1)
        opt = adamw.init(p, opt_cfg)
        step = train_loop.make_train_step(cfg, opt_cfg)
        for i in range(5):
            p, opt, m = step(p, opt, pipe.batch_at(i), i)
        outs[name] = float(m["loss"])
    assert abs(outs["f32"] - outs["posit"]) < 0.05 * abs(outs["f32"])


def test_grad_accum_matches_full_batch():
    """grad_accum=2 gives the full batch's update."""
    cfg1 = TCFG.get_config("whisper-tiny").reduced(compute_dtype="float32")
    cfg2 = dataclasses.replace(cfg1, grad_accum=2)
    pipe = Pipeline(DataConfig(seed=8), cfg1, global_batch=4, seq_len=32, device="cpu")
    batch = pipe.batch_at(0)
    opt_cfg = adamw.AdamWConfig(lr=1e-3)
    outs = []
    for cfg in (cfg1, cfg2):
        p = _init(cfg1, 5)
        opt = adamw.init(p, opt_cfg)
        p, o, m = train_loop.make_train_step(cfg, opt_cfg)(p, opt, batch, 0)
        outs.append((p, float(m["loss"])))
    assert abs(outs[0][1] - outs[1][1]) < 1e-5
    for a, b in zip(TT.leaves(outs[0][0]), TT.leaves(outs[1][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def _smoke_batch(cfg, rng, b=2, s=32):
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))}
    if cfg.family == "whisper":
        batch["frames"] = torch.randn((b, cfg.encoder_seq, cfg.d_model),
                                      generator=torch.Generator().manual_seed(0))
    if cfg.n_visual_tokens:
        batch["visual"] = torch.randn((b, cfg.n_visual_tokens, cfg.d_model),
                                      generator=torch.Generator().manual_seed(1))
    return batch


@pytest.mark.parametrize("arch", TCFG.ARCH_IDS)
def test_reduced_train_step(arch):
    """``tests/test_models_smoke.py::test_reduced_train_step`` on the
    port: a finite loss and gradient norm at the reduced config's own
    compute dtype, then one SGD step keeps the loss finite."""
    cfg = TCFG.get_config(arch).reduced()
    model = build(cfg, device="cpu")
    params = model.init_params(dtype=torch.float32)
    batch = _smoke_batch(cfg, np.random.default_rng(0))
    loss, grads = train_loop.make_grad_fn(dataclasses.replace(cfg, grad_accum=1))(
        params, batch)
    assert np.isfinite(float(loss)), f"{arch}: non-finite loss"
    assert np.isfinite(float(adamw.global_norm(grads))), f"{arch}: non-finite grads"
    with torch.no_grad():
        params2 = TT.tree_map(lambda p, g: p - 1e-3 * g, params, grads)
        assert np.isfinite(float(model.train_loss(params2, batch)))
