"""The port's training forward against the reference, every architecture.

At reduced width in f32 with the reference's parameters carried over by
``weights.params_from_jax``: ``train_loss`` within rel 1e-5 and each of
its gradient leaves within 1e-4 of that leaf's largest magnitude (the two
packages sum in other orders; the port's backward is autograd, the
reference's is ``jax.grad``), for every ``ARCH_ID``; ``logits_fn`` within
1e-4 for every family (the tolerance of ``tests/test_torch_engine.py``).
The recurrences' chunked training engines are held to the reference's
and to their own step forms: hymba's ``ssd_chunked`` and rwkv6's
``wkv_chunked``, their outputs and (rwkv6) the gradients through them.
Inputs are drawn from numpy seeds; the reference is jitted once a case.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as RCFG
from repro.models import get_family as ref_family
from repro.models import hymba as ref_hymba
from repro_torch import configs as TCFG
from repro_torch import tree as TT
from repro_torch.models import build, get_family, hymba, rwkv6
from repro_torch.weights import params_from_jax, params_to_jax

B, S = 2, 32
LOSS_RTOL, GRAD_TOL, LOGITS_TOL = 1e-5, 1e-4, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return (RCFG.get_config(arch).reduced(compute_dtype="float32"),
            TCFG.get_config(arch).reduced(compute_dtype="float32"))


def _params(rc, tc, seed=0):
    rp = ref_family(rc).init_params(jax.random.PRNGKey(seed), rc)
    return rp, params_from_jax(jax.tree.map(np.asarray, rp), tc, device="cpu")


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "whisper":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_visual_tokens:
        batch["visual"] = rng.standard_normal(
            (B, cfg.n_visual_tokens, cfg.d_model)).astype(np.float32)
    return batch


def assert_grads_close(port_grads, ref_grads, tol=GRAD_TOL):
    """Each leaf of the port's gradient tree (its own layout) within
    ``tol`` of the reference leaf's largest magnitude."""
    got = params_to_jax(port_grads)
    for path, want in jax.tree_util.tree_flatten_with_path(ref_grads)[0]:
        g = got
        for k in path:
            g = g[k.key]
        want = np.asarray(want)
        assert g.shape == want.shape, jax.tree_util.keystr(path)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(g - want).max())
        assert err <= tol * scale, (jax.tree_util.keystr(path), err, scale)


@pytest.mark.parametrize("arch", TCFG.ARCH_IDS)
def test_train_loss_and_grads_match_reference(arch):
    rc, tc = _cfgs(arch)
    rp, tp = _params(rc, tc)
    batch = _batch(rc)
    f = jax.jit(jax.value_and_grad(lambda p, b: ref_family(rc).train_loss(p, b, rc)))
    want_loss, want_grads = f(rp, {k: jnp.asarray(v) for k, v in batch.items()})

    model = build(tc, device="cpu")
    for p in TT.leaves(tp):
        p.requires_grad_(True)
    loss = model.train_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    assert_grads_close(TT.tree_map(lambda p: p.grad, tp), want_grads)


LOGIT_ARCHS = ["internvl2-1b", "rwkv6-7b", "hymba-1.5b", "whisper-tiny"]


@pytest.mark.parametrize("arch", LOGIT_ARCHS)
def test_logits_fn_matches_reference(arch):
    """Full-sequence logits for every family (internvl: the transformer
    with its visual prefix; rwkv6 through the scan engine)."""
    rc, tc = _cfgs(arch)
    rp, tp = _params(rc, tc, seed=1)
    batch = _batch(rc, seed=1)
    kw = {k: batch[k] for k in ("frames", "visual") if k in batch}
    want = jax.jit(lambda p, t, kw: ref_family(rc).logits_fn(p, t, rc, **kw))(
        rp, jnp.asarray(batch["tokens"]), {k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = get_family(tc).logits_fn(tp, torch.from_numpy(batch["tokens"]), tc,
                                       **{k: torch.from_numpy(v) for k, v in kw.items()})
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGITS_TOL, atol=LOGITS_TOL)


def _ssd_inputs(seed, s=32, h=4, p=8, n=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, s, h, p)).astype(np.float32)
    b_in = rng.standard_normal((B, s, n)).astype(np.float32)
    c_in = rng.standard_normal((B, s, n)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, s, h)))).astype(np.float32)
    a_log = (0.3 * rng.standard_normal(h)).astype(np.float32)
    h0 = rng.standard_normal((B, h, p, n)).astype(np.float32)
    return x, b_in, c_in, dt, a_log, h0


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunked_matches_reference_and_step_loop(chunk):
    """hymba's chunk-parallel SSD: the reference's ``ssd_chunked`` within
    1e-5, and the port's own ``ssd_step`` looped over the sequence within
    1e-4 (other summation orders), output and final state."""
    args = _ssd_inputs(3)
    y_ref, h_ref = jax.jit(ref_hymba.ssd_chunked, static_argnums=6)(
        *map(jnp.asarray, args), chunk)
    t = [torch.from_numpy(a) for a in args]
    y, h = hymba.ssd_chunked(*t, chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=1e-5, atol=1e-5)
    x, b_in, c_in, dt, a_log, state = t
    ys = []
    for i in range(x.shape[1]):
        yi, state = hymba.ssd_step(x[:, i], b_in[:, i], c_in[:, i], dt[:, i], a_log,
                                   state)
        ys.append(yi)
    np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(h.numpy(), state.numpy(), rtol=1e-4, atol=1e-4)


def test_wkv_chunked_equals_scan_in_training():
    """rwkv6's chunk-parallel WKV (training's engine) against the step
    recurrence: outputs, final state and the gradients of a loss through
    each with respect to r, k, v, w and u, each within 1e-4 of its
    largest magnitude (the gradients' tolerance above: the chunked form's
    w gradient runs through log-space cumulative sums)."""
    rng = np.random.default_rng(4)
    h, n, s = 2, 8, 32
    arrs = [rng.standard_normal((B, s, h, n)).astype(np.float32) for _ in range(3)]
    w = np.exp(-np.exp(rng.standard_normal((B, s, h, n)) - 1)).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    proj = torch.from_numpy(rng.standard_normal((B, s, h, n)).astype(np.float32))
    outs = []
    for engine in ("scan", "chunked"):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs + [w, u]]
        state = torch.zeros((B, h, n, n))
        if engine == "scan":
            out, st = rwkv6.wkv_scan(*leaves, state)
        else:
            out, st = rwkv6.wkv_chunked(*leaves, state, 8)
        ((out * proj).sum() + st.square().sum()).backward()
        outs.append([out.detach(), st.detach()] + [t.grad for t in leaves])
    for a, b in zip(*outs):
        scale = float(a.abs().max())
        assert float((b - a).abs().max()) <= 1e-4 * scale
