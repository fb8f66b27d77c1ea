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
Each move restores leaves (or shards) bit-equal to what was saved, each
shard the whole leaf cut as its spec says (cut here, independently of
the port's narrowing), and the next step from the restored state gives
the loss of an uninterrupted single-device run within 1e-5.  Weights
come from the reference's ``init_params``.
"""
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
from repro_torch.optim import adamw
from repro_torch.runtime import sharding, train_loop
from repro_torch.weights import params_from_jax

MESHES = {"dp": (2, 1), "tp": (1, 2)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """An uninterrupted single-device run (its state saved after two
    steps to ``one``), then the ranks' moves."""
    base = tmp_path_factory.mktemp("elastic")
    dirs = {k: str(base / k) for k in ("one", "dp", "tp")}
    rc = TL.lane_config(RCFG, TL.ELASTIC_ARCH)
    np_params = jax.tree.map(np.asarray, ref_family(rc).init_params(jax.random.PRNGKey(0), rc))
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
    ranks = M.spawn(TL.rank_elastic, ["cpu", "cpu"], (np_params, dirs), timeout=300,
                    threads=1)
    return dict(dirs=dirs, losses=losses, saved=saved, ranks=ranks, np_params=np_params)


def _cut(whole, spec, mesh_shape, rank):
    """Rank ``rank``'s piece of a whole leaf (numpy) on a row-major
    ``("data", "model")`` mesh of ``mesh_shape``."""
    coords = {"data": rank // mesh_shape[1], "model": rank % mesh_shape[1]}
    sizes = dict(zip(("data", "model"), mesh_shape))
    for dim, axis in enumerate(spec):
        if axis is not None:
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
    if name == "tp":     # the split leaves really are split
        assert any("model" in spec for spec in runs["ranks"][0][name]["specs"])
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
