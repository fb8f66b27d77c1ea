"""The elastic re-mesh: a checkpoint saved under one rank mesh restores
under another, on gloo ranks on the CPU.

The port of ``examples/elastic_restart.py`` and of
``tests/test_checkpoint.py::test_elastic_remesh_restore``: gemma-7b
reduced (tied embeddings), f32, posit16 moments, the example's data
(seed 17, 8 x 64).  Three moves, each after two steps: ``(data 2, model
1)`` -> one device, ``(data 1, model 2)`` -> one device, and one device
-> ``(data 1, model 2)``.  A save under a mesh writes whole leaves
(gathered over ``"model"``) in the single-device format; a restore with
``shardings=`` (``sharding.param_shardings``) gives each rank its piece.
A fourth move trains under FSDP at ``(data 2, model 1)`` (each rank
holds half of every leaf and of its posit16 ``m`` and f32 ``v``) and its
save restores on one device and onto FSDP at ``(data 4, model 1)``.
Each move restores leaves (or shards) bit-equal to what was saved, each
shard the whole leaf cut as its spec says (cut here, independently of
the port's narrowing), and the next step from the restored state gives
the loss of an uninterrupted single-device run within 1e-5.  Then
hymba-1.5b (reduced, f32, posit16 moments) trained two steps at ``(data
1, model 2)``, where its ``in_proj`` is a ``Segments`` leaf (a rank's
share of ``xs``, ``gate`` and ``dt``, the whole ``B`` and ``C``): the
ranks' losses are one device's within 1e-5, the save restores whole on
one device with each rank's leaves its cut bit for bit, segments
included, and restores onto a ``(data 1, model 4)`` placement.  Weights
come from the reference's ``init_params``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

import train_lanes as TL
from repro import configs as RCFG
from repro.models import get_family as ref_family
from repro_torch import configs as TCFG
from repro_torch import tree as TT
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch import mesh as M
from repro_torch.models import get_family
from repro_torch.optim import adamw
from repro_torch.runtime import sharding, train_loop
from repro_torch.weights import params_from_jax

MESHES = {"dp": (2, 1), "tp": (1, 2), "fsdp": (2, 1)}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads in this process (the ranks it spawns take one
    each, ``serve``'s a share of these two)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """An uninterrupted single-device run (its state saved after two
    steps to ``one``), then the ranks' moves."""
    base = tmp_path_factory.mktemp("elastic")
    dirs = {k: str(base / k) for k in ("one", "dp", "tp", "fsdp", "segments")}
    by_arch = {}
    for arch in (TL.ELASTIC_ARCH, TL.SEGMENTS_ARCH):
        rc = TL.lane_config(RCFG, arch)
        by_arch[arch] = jax.tree.map(np.asarray,
                                     ref_family(rc).init_params(jax.random.PRNGKey(0), rc))
    np_params = by_arch[TL.ELASTIC_ARCH]
    cfg, opt_cfg, pipe = TL.elastic_setup(TCFG)
    params = params_from_jax(np_params, cfg, device="cpu")
    opt = adamw.init(params, opt_cfg)
    step = train_loop.make_train_step(cfg, opt_cfg)
    losses = []
    for i in range(TL.ELASTIC_STEPS + 1):
        if i == TL.ELASTIC_STEPS:
            state = {"params": params, "opt": opt}
            Checkpointer(dirs["one"], keep=1).save(i, state, blocking=True)
            saved = [TL.bits(x) for x in TT.leaves(state)]
        params, opt, m = step(params, opt, pipe.batch_at(i), i)
        losses.append(float(m["loss"]))
    ranks = M.spawn(TL.rank_elastic, ["cpu", "cpu"], (by_arch, dirs), timeout=300,
                    threads=1)
    # hymba on one device, for the ranks' losses under "model" 2
    cfg, opt_cfg, pipe = TL.elastic_setup(TCFG, TL.SEGMENTS_ARCH)
    params = params_from_jax(by_arch[TL.SEGMENTS_ARCH], cfg, device="cpu")
    opt = adamw.init(params, opt_cfg)
    step = train_loop.make_train_step(cfg, opt_cfg)
    seg_losses = []
    for i in range(TL.ELASTIC_STEPS):
        params, opt, m = step(params, opt, pipe.batch_at(i), i)
        seg_losses.append(float(m["loss"]))
    return dict(dirs=dirs, losses=losses, saved=saved, ranks=ranks, np_params=np_params,
                by_arch=by_arch, seg_losses=seg_losses)


def _cut(whole, spec, mesh_shape, rank):
    """Rank ``rank``'s piece of a whole leaf (numpy) on a row-major
    ``("data", "model")`` mesh of ``mesh_shape``; a ``Segments`` dim cut
    segment by segment (a split one into equal pieces, a whole one
    kept)."""
    coords = {"data": rank // mesh_shape[1], "model": rank % mesh_shape[1]}
    sizes = dict(zip(("data", "model"), mesh_shape))
    for dim, axis in enumerate(spec):
        if isinstance(axis, sharding.Segments):
            bounds = np.cumsum((0,) + tuple(axis.sizes))
            parts = [np.take(whole, range(lo, hi), axis=dim) for lo, hi in
                     zip(bounds[:-1], bounds[1:])]
            whole = np.concatenate(
                [np.split(p, sizes[axis.axis], axis=dim)[coords[axis.axis]] if sp else p
                 for p, sp in zip(parts, axis.split)], axis=dim)
        elif axis is not None:
            whole = np.split(whole, sizes[axis], axis=dim)[coords[axis]]
    return whole


def _one_device(runs):
    cfg, opt_cfg, pipe = TL.elastic_setup(TCFG)
    params = params_from_jax(runs["np_params"], cfg, device="cpu")
    return cfg, opt_cfg, pipe, {"params": params, "opt": adamw.init(params, opt_cfg)}


@pytest.mark.parametrize("name", list(MESHES))
def test_ranks_train_as_one_device(runs, name):
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[name]["losses"], runs["losses"][:TL.ELASTIC_STEPS],
                                   rtol=1e-5)


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_checkpoint_restores_on_one_device(runs, name):
    """The ranks' save restores whole on one device: each rank's leaves
    are the restored leaves cut by their specs, bit for bit; the next
    step's loss is the uninterrupted run's."""
    cfg, opt_cfg, pipe, template = _one_device(runs)
    state, step0 = Checkpointer(runs["dirs"][name], keep=1).restore(TL.ELASTIC_STEPS,
                                                                   template)
    assert step0 == TL.ELASTIC_STEPS
    whole = [TL.bits(x) for x in TT.leaves(state)]
    for rank, r in enumerate(runs["ranks"]):
        got = r[name]
        assert len(got["leaves"]) == len(whole)
        for i, (w, piece, spec) in enumerate(zip(whole, got["leaves"], got["specs"])):
            np.testing.assert_array_equal(_cut(w, spec, MESHES[name], rank), piece,
                                          err_msg=str(i))
    if name != "dp":     # the split leaves really are split
        axis = {"tp": "model", "fsdp": "data"}[name]
        assert any(axis in spec for spec in runs["ranks"][0][name]["specs"])
    _, _, m = train_loop.make_train_step(cfg, opt_cfg)(
        state["params"], state["opt"], pipe.batch_at(step0), step0)
    assert abs(float(m["loss"]) - runs["losses"][-1]) <= 1e-5 * runs["losses"][-1]


def test_one_device_checkpoint_restores_under_model_parallel(runs):
    """One device's save restored at ``(data 1, model 2)``: each rank's
    leaves are the saved whole leaves cut by their specs, bit for bit,
    and the next step across the ranks gives the uninterrupted loss."""
    for rank, r in enumerate(runs["ranks"]):
        got = r["one"]
        assert got["step"] == TL.ELASTIC_STEPS
        assert len(got["leaves"]) == len(runs["saved"])
        for i, (w, piece, spec) in enumerate(zip(runs["saved"], got["leaves"],
                                                 got["specs"])):
            np.testing.assert_array_equal(_cut(w, spec, MESHES["tp"], rank), piece,
                                          err_msg=str(i))
        assert abs(got["loss"] - runs["losses"][-1]) <= 1e-5 * runs["losses"][-1]


class _Mesh:
    """A one-rank ``("data",)`` mesh stand-in."""
    mesh_dim_names = ("data",)

    def size(self, i=None):
        return 1

    def get_local_rank(self, name):
        return 0


def test_elastic_remesh_restore(tmp_path):
    """The invariant of the reference's ``test_elastic_remesh_restore``:
    saved under one layout, restored under a mesh's placement, the leaf
    is equal and takes the placement asked (replicated: whole)."""
    ck = Checkpointer(str(tmp_path), keep=1)
    t = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    ck.save(2, t, blocking=True)
    sh = {"w": sharding.NamedSharding(_Mesh(), (None, None))}
    restored, _ = ck.restore(2, t, shardings=sh)
    assert torch.equal(restored["w"], t["w"])
    split = {"w": sharding.NamedSharding(_Mesh(), ("data", None))}
    assert torch.equal(ck.restore(2, t, shardings=split)[0]["w"], t["w"])


class _DataMesh:
    """Rank ``rank`` of a ``(data n, model 1)`` mesh, as a restore's
    placement reads it (no collective)."""
    mesh_dim_names = ("data", "model")

    def __init__(self, n, rank):
        self.n, self.rank = n, rank

    def size(self, i=None):
        return (self.n, 1)[i]

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return self.rank if name == "data" else 0


def test_fsdp_checkpoint_restores_onto_data_4(runs):
    """The save under FSDP at data 2 restored onto FSDP at ``(data 4,
    model 1)``: each of the four ranks' leaves, posit16 ``m`` included,
    is the whole leaf cut by its spec there, bit for bit, and every leaf
    that 4 divides somewhere is a quarter."""
    cfg, _, _, template = _one_device(runs)
    cfg = dataclasses.replace(cfg, fsdp=True)
    ck = Checkpointer(runs["dirs"]["fsdp"], keep=1)
    whole_state = ck.restore(TL.ELASTIC_STEPS, template)[0]
    whole = [TL.bits(x) for x in TT.leaves(whole_state)]
    for rank in range(4):
        sh = TL.state_shardings(template, _DataMesh(4, rank), cfg)
        specs = [s.spec for s in TT.leaves(sh)]
        state, _ = ck.restore(TL.ELASTIC_STEPS, template, shardings=sh)
        for (path, x), w, spec in zip(TT.leaves_with_paths(state), whole, specs):
            np.testing.assert_array_equal(_cut(w, spec, (4, 1), rank), TL.bits(x),
                                          err_msg=path)
            if "data" in spec:
                assert x.numel() * 4 == w.size, path
        assert any(p.startswith("opt/m/") and "data" in spec and x.dtype == torch.uint16
                   for (p, x), spec in zip(TT.leaves_with_paths(state), specs))


class _ModelMesh:
    """Rank ``rank`` of a ``(data 1, model n)`` mesh, as a restore's
    placement reads it (no collective)."""
    mesh_dim_names = ("data", "model")

    def __init__(self, n, rank):
        self.n, self.rank = n, rank

    def size(self, i=None):
        return (1, self.n)[i]

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return 0 if name == "data" else self.rank


def _segments_template():
    cfg, opt_cfg, _ = TL.elastic_setup(TCFG, TL.SEGMENTS_ARCH)
    params = get_family(cfg).init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    return cfg, {"params": params, "opt": adamw.init(params, opt_cfg)}


def test_segments_ranks_train_as_one_device(runs):
    """hymba at ``(data 1, model 2)``: each rank's losses are one
    device's within 1e-5 (its partial gradients summed over "model")."""
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["segments"]["losses"], runs["seg_losses"], rtol=1e-5)


def test_segments_checkpoint_restores_on_one_device(runs):
    """The save under ``"model"`` 2 holds whole leaves: restored on one
    device, each leaf cut by a rank's spec is that rank's leaf bit for
    bit, ``in_proj``'s segments (and its moments') included."""
    cfg, template = _segments_template()
    state, step0 = Checkpointer(runs["dirs"]["segments"], keep=1).restore(
        TL.ELASTIC_STEPS, template)
    assert step0 == TL.ELASTIC_STEPS
    whole = [TL.bits(x) for x in TT.leaves(state)]
    paths = [p for p, _ in TT.leaves_with_paths(state)]
    for rank, r in enumerate(runs["ranks"]):
        got = r["segments"]
        assert len(got["leaves"]) == len(whole)
        for path, w, piece, spec in zip(paths, whole, got["leaves"], got["specs"]):
            np.testing.assert_array_equal(_cut(w, spec, TL.SEGMENTS_MESH, rank), piece,
                                          err_msg=path)
    segs = [p for p, spec in zip(paths, runs["ranks"][0]["segments"]["specs"])
            if any(isinstance(e, sharding.Segments) for e in spec)]
    assert len(segs) == 3 * cfg.n_layers      # in_proj, its m and its v, a layer


def test_segments_checkpoint_restores_onto_another_mesh(runs):
    """The same save restored onto ``(data 1, model 4)``, where the
    reduced hymba's heads do not split (2 KV heads) but its MLP and
    vocabulary do: each of the four ranks' leaves is the whole leaf cut
    by its spec there, bit for bit, and ``in_proj`` is whole."""
    cfg, template = _segments_template()
    ck = Checkpointer(runs["dirs"]["segments"], keep=1)
    whole = [TL.bits(x) for x in TT.leaves(ck.restore(TL.ELASTIC_STEPS, template)[0])]
    for rank in range(4):
        mesh = _ModelMesh(4, rank)
        sh = TL.state_shardings(template, mesh, cfg)
        specs = [s.spec for s in TT.leaves(sh)]
        state, _ = ck.restore(TL.ELASTIC_STEPS, template, shardings=sh)
        for (path, x), w, spec in zip(TT.leaves_with_paths(state), whole, specs):
            np.testing.assert_array_equal(_cut(w, spec, (1, 4), rank), TL.bits(x),
                                          err_msg=path)
            if path.endswith("in_proj/w"):
                assert spec == (None, None)
        assert any("model" in spec for spec in specs)
