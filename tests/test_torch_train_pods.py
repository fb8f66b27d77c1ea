"""The pod-compressed train step across gloo ranks on the CPU against the
reference's own compressed step, and its wire bit for bit.

The port of ``tests/test_distributed.py::test_compressed_multipod_
train_wire_is_posit16``: internvl2-1b reduced, f32, no visual tokens,
``grad_compress="posit16"``, pod 2 x data 2 x model 2, seed 9, one
step.  The target is the reference's compressed step itself, run as
that gate's script runs it (8 host devices in a subprocess) with one
change: its mesh is built with ``Auto`` axes.  Under jax 0.9
``jax.make_mesh`` defaults to ``Explicit`` axes, and the script's
``with_sharding_constraint`` then acts as an assert and fails
(ROADMAP.md Queue 3); with ``Auto`` axes it runs as it was written to.
The port's ranks (``make_train_step(n_pods=2, compressed=True,
mesh=)``) must give its loss within 1e-4 and each parameter after the
step within 1e-4; their error feedback is non-zero; and the wire
counter (``collectives.wire``) shows only posit16 patterns, two bytes
an element, crossing ``"pod"`` (beside the loss's one f32).  The error
feedback is not compared by tolerance: a gradient that rounds
differently can flip a pattern and move its residual by a whole posit
step.  The wire is compared bit for bit on one process instead: from
the reference's own per-pod gradients (its ``vmap`` of
``value_and_grad``), the port's compress -> gather -> decompress -> mean
gives the reference's patterns, new residuals and mean gradient.

The same ranks then take the step under FSDP (``fsdp=True``, the
reference dry run's multi-pod train cells): held to the reference's step
as above, and to the step without FSDP bit for bit on the rank's pieces
(the pod wire's patterns, the error feedback, the updated parameters),
the pod wire per rank half of that step's, and its save restored on one
device.  The same ranks run the serving steps under the mesh against
one device (``make_prefill_step``/``make_serve_step(mesh=)``, the dry
run's prefill and decode steps).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import train_lanes as TL
from repro import configs as RCFG
from repro.compress import gradient as RG
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import Pipeline as RPipeline
from repro.models import get_family as ref_family
from repro_torch import tree as TT
from repro_torch.compress import gradient as TG
from repro_torch.core.types import signed_view
from repro_torch.launch import mesh as M
from repro_torch.runtime import train_loop

# the gate's script (tests/test_distributed.py), its mesh with Auto axes,
# writing the parameters after the step to the file named in argv[1]
_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, dataclasses
import numpy as np
import jax, jax.numpy as jnp

from repro import configs
from repro.models import get_family
from repro.optim import adamw
from repro.runtime import sharding, train_loop
from repro.data.pipeline import DataConfig, Pipeline
from repro.launch.hlo_analysis import collective_bytes

cfg = configs.get_config("internvl2-1b").reduced(compute_dtype="float32")
cfg = dataclasses.replace(cfg, fsdp=False, seq_shard_activations=False,
                          batch_axes=("pod", "data"),
                          grad_compress="posit16", n_visual_tokens=0)
fam = get_family(cfg)
opt_cfg = adamw.AdamWConfig(lr=1e-3)
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)

params = fam.init_params(jax.random.PRNGKey(0), cfg)
opt = adamw.init(params, opt_cfg)
ef = jax.tree.map(lambda p: jnp.zeros((2,) + p.shape, jnp.float32), params)
pipe = Pipeline(DataConfig(seed=9), cfg, global_batch=8, seq_len=32)
batch = pipe.batch_at(0)
tiled = jax.tree.map(lambda x: x.reshape((2, 4) + x.shape[1:]), batch)

step_fn = train_loop.make_train_step(cfg, opt_cfg, n_pods=2,
                                     compressed=True)
with sharding.set_mesh(mesh):
    jitted = jax.jit(step_fn)
    lowered = jitted.lower(params, opt, ef, tiled, jnp.asarray(0))
    compiled = lowered.compile()
    colls = collective_bytes(compiled.as_text())
    has_u16_gather = "u16" in compiled.as_text() and \
        colls.get("all-gather", 0) > 0
    p2, o2, ef2, m2 = compiled(params, opt, ef, tiled, jnp.asarray(0))
flat = jax.tree_util.tree_flatten_with_path(p2)[0]
np.savez(sys.argv[1], **{"/".join(str(k.key) for k in path): np.asarray(x)
                         for path, x in flat})
print(json.dumps({
    "loss": float(m2["loss"]),
    "grad_norm": float(m2["grad_norm"]),
    "has_u16_gather": bool(has_u16_gather),
    "ef_nonzero": bool(any(float(jnp.abs(x).max()) > 0
                           for x in jax.tree.leaves(ef2))),
}))
"""


def _ref_params(rc):
    return ref_family(rc).init_params(jax.random.PRNGKey(0), rc)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's compressed step in its subprocess and the port's
    eight ranks, side by side."""
    rc = TL.pod_config(RCFG)
    np_params = jax.tree.map(np.asarray, _ref_params(rc))
    out = tmp_path_factory.mktemp("pods") / "params.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _SCRIPT, str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ckdir = tmp_path_factory.mktemp("pods_fsdp_ckpt")
        ranks = M.spawn(TL.rank_pods, ["cpu"] * 8, (np_params, str(ckdir)), timeout=300,
                        threads=1)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, stderr[-4000:]
    ref = json.loads(stdout.strip().splitlines()[-1])
    with np.load(out) as z:
        ref["params"] = {k: z[k] for k in z.files}
    return {"ref": ref, "ranks": ranks}


def test_compressed_step_matches_reference(runs):
    ref, ranks = runs["ref"], runs["ranks"]
    assert ref["has_u16_gather"] and ref["ef_nonzero"]
    for r in ranks:
        assert abs(r["loss"] - ref["loss"]) < 1e-4, (r["loss"], ref["loss"])
    np.testing.assert_allclose(ranks[0]["grad_norm"], ref["grad_norm"], rtol=1e-4)
    got = dict(TT.leaves_with_paths(ranks[0]["params"]))
    assert sorted(got) == sorted(ref["params"])
    for path, want in ref["params"].items():
        assert got[path].shape == want.shape, path
        assert float(np.abs(got[path] - want).max()) < 1e-4, path


def test_error_feedback_is_nonzero_on_every_rank(runs):
    assert all(r["ef_nonzero"] for r in runs["ranks"])


def test_only_posit16_patterns_cross_the_pod_axis(runs):
    """Each rank's gradient crosses "pod" as its posit16 patterns, every
    leaf from each pod (two bytes an element, its slice's elements); the
    one other collective on that axis is the loss's f32 scalar; no f32
    gradient crosses it."""
    for r in runs["ranks"]:
        pod = {k: v for k, v in r["wire"].items() if k.startswith("pod/")}
        grads = {k: v for k, v in pod.items() if k.split("/")[2] == "grad"}
        assert set(grads) == {"pod/broadcast/grad/uint16"}, pod
        calls, nbytes = grads["pod/broadcast/grad/uint16"]
        assert nbytes == 2 * 2 * r["n_elems"]
        assert set(pod) - set(grads) == {"pod/all_reduce/loss/float32"}
        assert pod["pod/all_reduce/loss/float32"] == [1, 4]


def test_fsdp_pod_step_matches_reference(runs):
    """The same step under FSDP (``cfg.fsdp``: each rank holds its pieces
    over ``"data"``, the gradient reduce-scattered within its pod) on the
    same eight ranks: the reference's compressed step within 1e-4, as
    the step without FSDP is held."""
    ref, ranks = runs["ref"], runs["ranks"]
    for r in ranks:
        assert abs(r["fsdp"]["loss"] - ref["loss"]) < 1e-4, (r["fsdp"]["loss"], ref["loss"])
    np.testing.assert_allclose(ranks[0]["fsdp"]["grad_norm"], ref["grad_norm"], rtol=1e-4)
    got = dict(TT.leaves_with_paths(ranks[0]["fsdp"]["params"]))
    assert sorted(got) == sorted(ref["params"])
    for path, want in ref["params"].items():
        assert got[path].shape == want.shape, path
        assert float(np.abs(got[path] - want).max()) < 1e-4, path


def test_fsdp_pod_step_is_the_sliced_step_bit_for_bit(runs):
    """Each rank's FSDP pieces after the step, its patterns on the pod
    wire and its new error feedback are the step's without FSDP, sliced
    to the rank's pieces, bit for bit; its loss and gradient norm equal
    that step's."""
    for r in runs["ranks"]:
        f = r["fsdp"]
        assert f["sliced_equal"], f["differ"]
        assert f["loss"] == r["loss"]
        assert f["grad_norm"] == r["grad_norm"]


def test_fsdp_pod_wire_is_half_and_posit16(runs):
    """Under FSDP only posit16 patterns of the rank's pieces cross "pod"
    (beside the loss's f32), and, every leaf of the reduced model
    splitting over data 2, half the bytes of the step without FSDP."""
    for r in runs["ranks"]:
        f = r["fsdp"]
        assert f["n_split"] == f["n_leaves"]
        pod = {k: v for k, v in f["wire"].items() if k.startswith("pod/")}
        assert set(pod) == {"pod/broadcast/grad/uint16", "pod/all_reduce/loss/float32"}, pod
        assert pod["pod/broadcast/grad/uint16"][1] == 2 * 2 * f["n_elems"]
        assert 2 * pod["pod/broadcast/grad/uint16"][1] == \
            r["wire"]["pod/broadcast/grad/uint16"][1]


def test_fsdp_pod_save_restores_on_one_device(runs):
    """The FSDP pod step's pieces and optimizer state saved under the
    mesh (each leaf gathered whole) and restored on one device: every
    rank's pieces of the whole leaves are its own, bit for bit."""
    assert all(r["fsdp"]["restored_equal"] for r in runs["ranks"])


def test_serve_steps_under_the_mesh_match_one_device(runs):
    """``make_prefill_step(mesh=)`` and ``make_serve_step(mesh=)`` on each
    rank's shard (the KV heads split over "model" 2, the cache the
    rank's share) give one device's logits within 1e-4 (f32)."""
    for r in runs["ranks"]:
        assert r["serve"]["kv_split"]
        assert r["serve"]["prefill"] < 1e-4 and r["serve"]["decode"] < 1e-4, r["serve"]


def test_the_wire_is_the_references_bit_for_bit():
    """From the reference's per-pod gradients and a non-zero residual:
    the port's quantize with feedback, the pods' patterns stacked as
    the gather stacks them, and ``pod_mean`` give the reference's ``q``,
    new ``ef`` and ``g_hat`` bit for bit."""
    rc = TL.pod_config(RCFG)
    fam = ref_family(rc)
    params = _ref_params(rc)
    batch = RPipeline(RDataConfig(seed=TL.POD_SEED), rc, global_batch=8,
                      seq_len=32).batch_at(0)
    tiled_b = jax.tree.map(lambda x: x.reshape((2, 4) + x.shape[1:]), batch)
    tiled_p = jax.tree.map(lambda p: jnp.broadcast_to(p[None], (2,) + p.shape), params)
    _, grads = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p, b: fam.train_loss(p, b, rc))))(tiled_p, tiled_b)
    rng = np.random.default_rng(3)
    ef0 = jax.tree.map(lambda g: jnp.asarray(
        rng.standard_normal(g.shape).astype(np.float32) * 1e-5), grads)
    q, ef = RG.compress_with_feedback(grads, ef0, "posit16")
    g_hat = jax.tree.map(lambda t: t.mean(axis=0), RG.decompress(q, "posit16"))

    def t(tree, pod):
        return jax.tree.map(lambda a: torch.from_numpy(np.array(a[pod])), tree)

    qs, efs = zip(*(TG.compress_with_feedback(t(grads, p), t(ef0, p), "posit16")
                    for p in range(2)))
    gathered = TT.tree_map(lambda *xs: torch.stack(xs), *qs)
    got_hat = train_loop.pod_mean(gathered, "posit16")
    for path, want in jax.tree_util.tree_flatten_with_path(q)[0]:
        keys = [k.key for k in path]
        pick = lambda tree: _at(tree, keys)         # noqa: E731
        np.testing.assert_array_equal(signed_view(pick(gathered)).numpy(),
                                      np.asarray(want).view(np.int16))
        np.testing.assert_array_equal(
            torch.stack([pick(e) for e in efs]).numpy().view(np.uint32),
            np.asarray(_at(ef, keys)).view(np.uint32))
        np.testing.assert_array_equal(pick(got_hat).numpy().view(np.uint32),
                                      np.asarray(_at(g_hat, keys)).view(np.uint32))


def _at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name,bits", [("posit16", 16), ("posit8", 8)])
def test_decompress_equals_reference_on_every_pattern(name, bits):
    """``decompress`` on the CPU (the plain version of row 2), on every
    pattern, NaR included, as a pod-stacked leaf: the reference's f32
    bits."""
    pats = np.arange(1 << bits, dtype=np.uint16 if bits == 16 else np.uint8)
    stacked = pats.reshape(2, -1)
    want = np.asarray(RG.decompress({"w": jnp.asarray(stacked)}, name)["w"])
    got = TG.decompress({"w": torch.from_numpy(stacked.astype(np.int64)).to(
        torch.uint16 if bits == 16 else torch.uint8)}, name)["w"]
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
