"""The port's MoE feed-forward (``layers.moe``) against the reference's.

At reduced width (E = 4 experts, top 2, capacity ``int(0.625 S)``) in
f32: row-local dispatch over (B, S) inputs with S from 1 to 16, where
capacity binds, must keep and drop the same choices as the reference's
``_moe_row`` (the kept set, the slot each choice takes, the order) and
give outputs within 1e-6.  Left-padded rows (identical pad vectors, so
the router ties among them and the stable sort decides who keeps a
slot), an exact router tie (a zero router: every expert equally
likely, top-k takes the lowest indices as ``lax.top_k`` does) and bf16
compute are checked too.  The reference's MoE subtree carries over with
``weights.params_from_jax`` in its shapes.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as RCFG
from repro.models import get_family
from repro.models import layers as RL
from repro_torch import configs as TCFG
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.weights import params_from_jax

ARCHS = ["granite-moe-3b-a800m", "dbrx-132b"]
TOL = 1e-6              # f32: the two packages sum the expert products in other orders
# bf16 compute: outputs reach |y| ~ 4 after three bf16 roundings (the
# expert products, the activation, the output); 2**-4 is 2 % of that,
# some 4-8 bf16 ulps (each package alone lies within 0.04 of f32)
BF16_TOL = 2 ** -4


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfgs(arch="granite-moe-3b-a800m", compute="float32"):
    return (RCFG.get_config(arch).reduced(compute_dtype=compute),
            TCFG.get_config(arch).reduced(compute_dtype=compute))


def _moe_params(rc, seed=0, zero_router=False):
    rp = RL.init_moe(jax.random.PRNGKey(seed), rc)
    if zero_router:
        rp = dict(rp, router={"w": jnp.zeros_like(rp["router"]["w"])})
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rp)
    return rp, tp


def _reference(rp, x, rc):
    """The reference's output and its per-row routing aux."""
    xj = jnp.asarray(x)
    y = RL.moe(rp, xj, rc)
    _, aux = jax.vmap(lambda r: RL._moe_row(rp, r, rc))(xj)
    return np.asarray(y, np.float32), [np.asarray(a) for a in aux]


def _port(tp, x, tc, dtype=torch.float32):
    xt = torch.from_numpy(np.array(x)).to(dtype)
    y = L.moe(tp, xt, tc)
    _, aux = L._moe_dispatch(tp, xt, tc)
    return y.to(torch.float32).numpy(), [a.to(torch.float32).numpy()
                                         if a.is_floating_point() else a.numpy()
                                         for a in aux]


def _assert_same_routing(got, want):
    order, dest, keep, gate_w = got
    np.testing.assert_array_equal(keep, want[2])            # kept / dropped
    np.testing.assert_array_equal(dest, want[1])            # the slot of each
    np.testing.assert_array_equal(order, want[0])
    np.testing.assert_allclose(gate_w, want[3], rtol=0, atol=TOL)


@pytest.mark.parametrize("s", [1, 2, 3, 4, 5, 7, 8, 11, 13, 16])
@pytest.mark.parametrize("arch", ARCHS, ids=["granite-moe", "dbrx"])
def test_moe_matches_reference(arch, s):
    rc, tc = _cfgs(arch)
    rp, tp = _moe_params(rc, seed=s)
    x = np.random.default_rng(s).standard_normal((3, s, tc.d_model)).astype(np.float32)
    want, raux = _reference(rp, x, rc)
    got, taux = _port(tp, x, tc)
    _assert_same_routing(taux, raux)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    cap = L._moe_capacity(s, tc)
    assert cap == RL._moe_capacity(s, rc) == int(max(1, 0.625 * s))
    if s >= 8:                       # S*k = 2S choices into 4 * int(0.625 S) slots
        assert not raux[2].all(), "capacity never bound"


def test_moe_left_padded_rows():
    """A ragged left-padded batch: every pad position carries the same
    vector (the pad token's embedding), so pad tokens tie in the router
    and take capacity before the real tokens of their expert; the stable
    sort decides which keep a slot, as in the reference."""
    rc, tc = _cfgs()
    rp, tp = _moe_params(rc, seed=7)
    rng = np.random.default_rng(7)
    s, lens = 12, (12, 5, 1, 8)
    pad = rng.standard_normal(tc.d_model).astype(np.float32)
    x = np.broadcast_to(pad, (len(lens), s, tc.d_model)).copy()
    for b, n in enumerate(lens):
        x[b, s - n:] = rng.standard_normal((n, tc.d_model))
    want, raux = _reference(rp, x, rc)
    got, taux = _port(tp, x, tc)
    _assert_same_routing(taux, raux)
    assert not raux[2].all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_moe_router_tie():
    """A zero router: every expert has probability 1/E, top-k takes
    experts 0 and 1 for every token (lower index first, as
    ``lax.top_k``), so only the first cap tokens of a row are served."""
    rc, tc = _cfgs()
    rp, tp = _moe_params(rc, seed=3, zero_router=True)
    x = np.random.default_rng(3).standard_normal((2, 9, tc.d_model)).astype(np.float32)
    want, raux = _reference(rp, x, rc)
    got, taux = _port(tp, x, tc)
    _assert_same_routing(taux, raux)
    cap = L._moe_capacity(9, tc)
    assert int(taux[2].sum()) == 2 * 2 * cap          # rows x experts 0, 1 x cap
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got[:, cap:], 0)    # past capacity: dropped


@pytest.mark.parametrize("seed", range(4))
def test_moe_top_k_breaks_ties_like_lax(seed):
    """Probabilities drawn from a few levels, so most rows tie: values and
    indices equal ``lax.top_k``'s (the lower index first)."""
    rng = np.random.default_rng(seed)
    probs = rng.integers(0, 3, (64, 8)).astype(np.float32) / 4
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_v, got_i = L.moe_top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_moe_bf16_compute():
    """bf16 activations and weights: the same routing, outputs within
    ``BF16_TOL`` (each package rounds its products to bf16 on its own)."""
    rc, tc = _cfgs(compute="bfloat16")
    rp, tp = _moe_params(rc, seed=5)
    tp = jax.tree.map(lambda t: t.to(torch.bfloat16), tp)
    x = np.random.default_rng(5).standard_normal((3, 8, tc.d_model)).astype(np.float32)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    rpb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), rp)
    want = np.asarray(RL.moe(rpb, jnp.asarray(xb, jnp.bfloat16), rc), np.float32)
    _, raux = jax.vmap(lambda r: RL._moe_row(rpb, r, rc))(jnp.asarray(xb, jnp.bfloat16))
    got, taux = _port(tp, xb, tc, dtype=torch.bfloat16)
    np.testing.assert_array_equal(taux[2], np.asarray(raux[2]))
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL)
    # and against the f32 computation on the same bf16-rounded operands
    f32 = L.moe(jax.tree.map(lambda t: t.to(torch.float32), tp), torch.from_numpy(xb.copy()),
                dataclasses.replace(tc, compute_dtype="float32")).numpy()
    np.testing.assert_allclose(got, f32, rtol=0, atol=BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS, ids=["granite-moe", "dbrx"])
def test_params_from_jax_carries_the_moe_subtree(arch):
    """The reference's stacked MoE leaves become each layer's ``moe``
    dict in the port's shapes: ``router.w`` (D, E), ``wi``/``wg`` (E, D,
    F), ``wo`` (E, F, D), values unchanged; the port's own init builds
    the same tree."""
    rc, tc = _cfgs(arch)
    rp = jax.tree.map(np.asarray, get_family(rc).init_params(jax.random.PRNGKey(0), rc))
    tp = params_from_jax(rp, tc, device="cpu")
    d, e, f = tc.d_model, tc.n_experts, tc.d_ff_expert
    shapes = {"router": (d, e), "wi": (e, d, f), "wg": (e, d, f), "wo": (e, f, d)}
    own = T.init_params(tc, seed=0, device="cpu")
    for li, layer in enumerate(tp["layers"]):
        assert "mlp" not in layer and set(layer["moe"]) == set(shapes)
        for key, shape in shapes.items():
            got = layer["moe"][key]["w"] if key == "router" else layer["moe"][key]
            want = rp["layers"]["moe"][key]
            want = (want["w"] if key == "router" else want)[li]
            assert tuple(got.shape) == shape
            np.testing.assert_array_equal(got.numpy(), want)
            mine = own["layers"][li]["moe"]
            assert tuple((mine[key]["w"] if key == "router" else mine[key]).shape) == shape
