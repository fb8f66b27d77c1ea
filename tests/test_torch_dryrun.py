"""The dry run (``repro_torch.launch.dryrun``) against the reference's.

No spawn: the cells trace in this process on fake tensors, under a fake
process group at the production world size.  Held to the reference:

* the grid (``configs.all_cells``, ``supported_shapes``) and every field
  of ``config_for_cell``;
* ``launch/specs``: the inputs, parameters, caches and posit-weight
  serving parameters of every cell at full width, leaf by leaf in shape
  and dtype against ``jax.eval_shape``'s trees (stacked layers unstacked
  as ``weights.params_from_jax`` unstacks them);
* ``launch/cost``: ``model_flops``, ``active_param_count`` and the keys of
  ``roofline_terms`` (the rates are the H100's, not the reference's TPU);
* the per-device bytes of the parameters, AdamW's state and the error
  feedback at ``16x16`` and ``2x16x16`` against the reference's
  ``param_shardings`` / ``_ef_shardings`` (``NamedSharding.shard_shape``
  in one subprocess of 512 host devices, nothing compiled), leaf by
  leaf; the leaves whose bytes differ must be the divergence tables'
  and are listed with both counts.

Then the trace itself: a reduced step's FLOPs, argument bytes and
launches on fake tensors equal a real CPU run's; the codec's operators'
fake outputs are the plain versions' in shape, dtype and device; and a
few full-width cells trace end to end (a decode, a prefill and a train
cell at 16x16, and a multi-pod train cell under FSDP and compression,
their depth cut to keep the file quick).  About 90 s alone.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as RC
from repro.launch import hlo_analysis as RH
from repro.launch import specs as RS
from repro.launch.dryrun import _serve_params_shape as ref_serve_params_shape
from repro_torch import configs as TC
from repro_torch import tree as TT
from repro_torch.core.types import POSIT8, POSIT16
from repro_torch.kernels import posit_codec
from repro_torch.launch import cost, dryrun, specs
from repro_torch.models import get_family
from repro_torch.optim import adamw
from repro_torch.runtime import sharding, train_loop
from repro_torch.weights import _STACKED

CELLS = list(RC.all_cells())


def test_grid_and_cell_configs_are_the_references():
    assert list(TC.all_cells()) == CELLS and len(CELLS) == 32
    assert TC.ARCH_IDS == RC.ARCH_IDS
    assert {s.name: dataclasses.asdict(s) for s in TC.ALL_SHAPES} == \
        {s.name: dataclasses.asdict(s) for s in RC.ALL_SHAPES}
    for arch in RC.ARCH_IDS:
        assert tuple(TC.supported_shapes(arch)) == tuple(RC.supported_shapes(arch))
    for arch, shape in CELLS:
        ref = dataclasses.asdict(RC.config_for_cell(arch, shape))
        got = dataclasses.asdict(TC.config_for_cell(arch, shape))
        assert set(ref) <= set(got), set(ref) - set(got)
        for k, v in ref.items():
            assert got[k] == (list(v) if isinstance(got[k], list) else v), (arch, shape, k)


def _ref_leaves(tree, cfg):
    """``{path: (shape, dtype name)}`` of a reference tree in the port's
    layout: each stacked per-layer tree unstacked into its layers."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        shape, dt = tuple(leaf.shape), np.dtype(leaf.dtype).name
        if keys[0] in _STACKED:
            for i in range(_STACKED[keys[0]](cfg)):
                out["/".join([keys[0], str(i)] + keys[1:])] = (shape[1:], dt)
        else:
            out["/".join(keys)] = (shape, dt)
    return out


def _port_leaves(tree):
    return {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in TT.leaves_with_paths(tree) if isinstance(x, torch.Tensor)}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_specs_match_reference_leaf_by_leaf(arch, shape):
    """Every cell at full width: the batch, the parameters (the decode
    cells' posit-weight serving parameters where the config serves
    them) and the cache, leaf by leaf in shape and dtype.  The cache's
    ``len`` and ``max_len`` are Python ints in the port: compared by
    name."""
    rcfg, tcfg = RC.config_for_cell(arch, shape), TC.config_for_cell(arch, shape)
    rspec, tspec = RC.SHAPES[shape], TC.SHAPES[shape]
    want = {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in RS.input_specs(rcfg, rspec).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in specs.input_specs(tcfg, tspec).items()}
    assert got == want
    rp = RS.params_shape(rcfg)
    with specs.fake_mode():
        tp = specs.params_shape(tcfg)
        assert _port_leaves(tp) == _ref_leaves(rp, rcfg)
        if tspec.kind == "decode":
            assert _port_leaves(specs.serve_params_shape(tcfg, tp)) == \
                _ref_leaves(ref_serve_params_shape(rcfg, rp), rcfg)
        rcache = RS.cache_shape(rcfg, rspec)
        tcache = specs.cache_shape(tcfg, tspec)
        assert set(tcache) == set(rcache)
        assert _port_leaves(tcache) == {k: v for k, v in _ref_leaves(rcache, rcfg).items()
                                        if v[0] != ()}
    assert tuple(specs.decode_token_spec(tspec).shape) == RS.decode_token_spec(rspec).shape


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cost_model_matches_reference(arch, shape):
    """The useful-FLOP yardstick and the active parameters equal the
    reference's; the roofline has its keys and its formulas, at the
    H100's rates (989.4 TFLOP/s, 3.35 TB/s, 450 GB/s) in place of the
    reference's TPU ones (197 TFLOP/s, 819 GB/s, 50 GB/s)."""
    rcfg, tcfg = RC.config_for_cell(arch, shape), TC.config_for_cell(arch, shape)
    assert cost.active_param_count(tcfg) == RH.active_param_count(rcfg)
    assert cost.model_flops(tcfg, TC.SHAPES[shape]) == RH.model_flops(rcfg, RC.SHAPES[shape])
    kw = dict(flops_per_chip=3.0e14, bytes_per_chip=2.0e12, coll_bytes_per_chip=5.0e10,
              n_chips=256)
    ref, got = RH.roofline_terms(**kw), cost.roofline_terms(**kw)
    assert set(got) == set(ref)
    assert got["compute_s"] == kw["flops_per_chip"] / cost.PEAK_FLOPS
    assert got["memory_s"] == kw["bytes_per_chip"] / cost.HBM_BW
    assert got["collective_s"] == kw["coll_bytes_per_chip"] / cost.LINK_BW
    assert (got["total_flops"], got["total_bytes"]) == (ref["total_flops"], ref["total_bytes"])
    assert (cost.PEAK_FLOPS, cost.HBM_BW, cost.LINK_BW) != (RH.PEAK_FLOPS, RH.HBM_BW,
                                                            RH.LINK_BW)


# the reference's per-device bytes of every train cell's parameters,
# AdamW state (posit16 m, the dry run's) and error feedback, by leaf, at
# both meshes; stacked leaves as the reference holds them
_BYTES_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.launch import specs
from repro.launch.dryrun import _ef_shardings
from repro.launch.mesh import make_production_mesh
from repro.optim import adamw
from repro.runtime import sharding

def per_leaf(tree, shardings, lead=()):
    out = {}
    for (path, leaf), sh in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                jax.tree.leaves(shardings)):
        shape = lead + tuple(leaf.shape)
        n = int(np.prod(sh.shard_shape(shape), dtype=np.int64))
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        itemsize = 4 if lead else np.dtype(leaf.dtype).itemsize
        out[key] = n * itemsize
    return out

res = {}
for arch in configs.ARCH_IDS:
    cfg = configs.config_for_cell(arch, "train_4k")
    p = specs.params_shape(cfg)
    o = jax.eval_shape(lambda q: adamw.init(q, adamw.AdamWConfig(posit_moments=True)), p)
    for multi in (False, True):
        c = dataclasses.replace(cfg, batch_axes=("pod", "data")) if multi else cfg
        mesh = make_production_mesh(multi_pod=multi)
        rec = {"params": per_leaf(p, sharding.param_shardings(p, mesh, fsdp=c.fsdp)),
               "opt": per_leaf(o, sharding.param_shardings(o, mesh, fsdp=c.fsdp))}
        if multi and c.grad_compress:
            rec["ef"] = per_leaf(p, _ef_shardings(p, mesh, c, 2), lead=(2,))
        res[f"{arch}|{'2x16x16' if multi else '16x16'}"] = rec
print(json.dumps(res))
"""


class _Mesh:
    """A stand-in of a rank's ``DeviceMesh`` for placements alone: its
    axes and sizes (rank 0 of each; no process group)."""

    def __init__(self, shape, names):
        self.shape_, self.mesh_dim_names = tuple(shape), tuple(names)

    def size(self, i):
        return self.shape_[i]

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return 0


@pytest.fixture(scope="module")
def ref_bytes():
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _BYTES_SCRIPT], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port_bytes(tree, shardings, lead=()):
    """Per-device bytes by leaf, the layers of a stacked tree summed
    under the reference's stacked path."""
    out = {}
    for (path, x), sh in zip(TT.leaves_with_paths(tree), TT.leaves(shardings)):
        shape = sh.shard_shape(lead + tuple(x.shape))
        n = int(np.prod(shape, dtype=np.int64)) * (4 if lead else x.element_size())
        key = re.sub(r"(^|/)(layers|enc_layers|dec_layers)/\d+/", r"\1\2/", path)
        out[key] = out.get(key, 0) + n
    return out


_DIVERGENT = sharding.DIVERGENCES + sharding.FSDP_DIVERGENCES


def _whole_group(path: str, cfg) -> bool:
    """A leaf of a group that does not split on whole heads, experts or
    vocabulary rows at "model" 16: the port keeps it whole on every rank
    where the reference's rule table may split its flat features."""
    group = sharding._group_of(re.sub(r"^(m|v)/", "", path), cfg)
    return group is not None and not sharding._split_groups(cfg, 16)[group]


def _explained(path: str, cfg, kind: str) -> bool:
    """A leaf whose per-device bytes may differ from the reference's:
    one the divergence tables name (a stacked path stands for every
    layer's), one of a group that does not split (:func:`_whole_group`),
    or any residual of a config without FSDP (the reference's
    ``_ef_shardings`` always adds the ZeRO axis; the port's residual is
    shaped like the rank's parameter)."""
    if kind == "ef" and not cfg.fsdp:
        return True
    layer = re.sub(r"(^|/)(layers|enc_layers|dec_layers)/", r"\1\2/0/", path)
    return any(re.search(p, layer) for p in _DIVERGENT) or _whole_group(layer, cfg)


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_per_device_bytes_match_reference(arch, ref_bytes):
    """Parameters, AdamW state and error feedback a device holds in the
    train cells at both meshes, leaf by leaf against the reference's
    placements; the leaves that differ are named by the divergence
    tables, and their bytes are printed beside the reference's."""
    cfg = TC.config_for_cell(arch, "train_4k")
    with specs.fake_mode():
        p = specs.params_shape(cfg, device="cpu")
        o = adamw.init(p, adamw.AdamWConfig(posit_moments=True))
    for multi in (False, True):
        tag = "2x16x16" if multi else "16x16"
        shape, names = dryrun.MESHES[multi]
        mesh = _Mesh(shape, names)
        got = {"params": _port_bytes(p, sharding.param_shardings(p, mesh, cfg=cfg,
                                                                 fsdp=cfg.fsdp)),
               "opt": _port_bytes(o, sharding.param_shardings(o, mesh, cfg=cfg, fsdp=cfg.fsdp))}
        if multi and cfg.grad_compress:
            got["ef"] = _port_bytes(p, sharding.ef_shardings(p, mesh, cfg), lead=(2,))
        want = ref_bytes[f"{arch}|{tag}"]
        assert set(got) == set(want)
        for kind in want:
            assert set(got[kind]) == set(want[kind]), (kind, set(got[kind]) ^ set(want[kind]))
            differ = {k: (got[kind][k], want[kind][k]) for k in want[kind]
                      if got[kind][k] != want[kind][k]}
            if differ:
                print(f"{arch} {tag} {kind}: port vs reference bytes a device "
                      f"(divergences): {differ}")
            bad = [k for k in differ if not _explained(k, cfg, kind)]
            assert not bad, {k: differ[k] for k in bad}


def test_codec_ops_fake_outputs_are_the_plain_versions():
    """Each operator's fake implementation gives the plain version's
    outputs in shape, dtype and device, and the fused write mutates its
    arenas in place."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 5, 7)).astype(np.float32))
    for cfg in (POSIT16, POSIT8):
        q = posit_codec.quantize(x, cfg)
        deq = posit_codec.dequantize_many([q, q[:2]], cfg, round_to=torch.bfloat16)
        arena = torch.zeros((4, 2, 5, 7), dtype=cfg.storage_dtype)
        slots = torch.tensor([0, 5, -1])
        posit_codec.paged_write([(arena, x)], slots, cfg)
        assert int((arena != 0).sum()) > 0
        mode = FakeTensorMode()
        fx, fa, fslots = (mode.from_tensor(t) for t in (x, torch.zeros_like(arena), slots))
        with mode:
            fq = posit_codec.quantize(fx, cfg)
            fdeq = posit_codec.dequantize_many([fq, fq[:2]], cfg, round_to=torch.bfloat16)
            posit_codec.paged_write([(fa, fx)], fslots, cfg)
        for a, b in [(fq, q)] + list(zip(fdeq, deq)):
            assert (a.shape, a.dtype, a.device) == (b.shape, b.dtype, b.device)


@pytest.mark.parametrize("arch", ["gemma-7b", "granite-moe-3b-a800m"])
def test_fake_trace_counts_equal_a_real_cpu_run(arch):
    """The reduced config's train step (``grad_accum`` 2, posit16
    moments): its FLOPs, argument bytes and kernel calls traced on fake
    tensors equal those of the same step run for real on the CPU."""
    from repro_torch.data.pipeline import DataConfig, Pipeline

    cfg = dataclasses.replace(TC.get_config(arch).reduced(compute_dtype="float32"),
                              grad_accum=2)
    b, s = 4, 32
    opt_cfg = adamw.AdamWConfig(posit_moments=True)
    step = train_loop.make_train_step(cfg, opt_cfg)
    with specs.fake_mode():
        fp = specs.params_shape(cfg, device="cpu")
        fopt = adamw.init(fp, opt_cfg)
        fbatch = specs.materialize({"tokens": specs.TensorSpec((b, s), torch.int32)}, "cpu")
        fake, _ = dryrun.trace_step(step, (fp, fopt, fbatch, 0))
        fake_args = dryrun._nbytes((fp, fopt, fbatch))
    params = get_family(cfg).init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    opt = adamw.init(params, opt_cfg)
    batch = Pipeline(DataConfig(seed=1), cfg, b, s, device="cpu").batch_at(0)
    real, _ = dryrun.trace_step(step, (params, opt, batch, 0))
    assert fake_args == dryrun._nbytes((params, opt, batch))
    assert fake["flops"] == real["flops"] > 0
    assert fake["launches"] == real["launches"]
    n = len(TT.leaves(params))
    assert fake["launches"] == {"posit_quantize": n, "posit_dequantize": n}


@pytest.mark.parametrize("arch,shape,multi,layers", [
    ("phi3-medium-14b", "decode_32k", False, 4),
    ("dbrx-132b", "decode_32k", False, 2),
    ("internvl2-1b", "prefill_32k", False, 2),
    ("internvl2-1b", "train_4k", False, 2),
    ("granite-moe-3b-a800m", "train_4k", True, 2),
])
def test_full_width_cells_trace(arch, shape, multi, layers, tmp_path, monkeypatch):
    """Full-width cells traced end to end at a cut depth: each record is
    ``ok`` with its keys; the decode cells launch the fused write and the
    dequantize once a layer (dbrx's posit8 weights through the
    dequantize too); the multi-pod train cell is compressed under FSDP
    (error feedback of the rank's pieces, posit16 patterns alone on
    ``"pod"``)."""
    cell = TC.config_for_cell
    monkeypatch.setattr(TC, "config_for_cell", lambda a, s: dataclasses.replace(
        cell(a, s), n_layers=layers))
    rec = dryrun.run_cell(arch, shape, multi, str(tmp_path))
    assert rec["n_layers"] == layers
    assert rec["ok"] and rec["counted"]
    assert (tmp_path / f"{arch}__{shape}__{rec['mesh']}.json").exists()
    for key in ("argument_bytes_per_device", "output_bytes_per_device",
                "temp_bytes_per_device", "peak_bytes_per_device"):
        assert rec["memory"][key] >= 0
    assert rec["cost"]["flops_per_chip"] > 0 and rec["cost"]["bytes_per_chip"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["useful_flop_ratio"] > 0
    cfg = TC.config_for_cell(arch, shape)
    if rec["kind"] == "decode":
        assert rec["launches"]["posit_paged_write"] == layers
        per_layer = 8 if cfg.weight_posit else 1     # dbrx: attention and experts' weights
        assert rec["launches"]["posit_dequantize"] >= per_layer * layers
    if multi:
        assert rec["compressed"] and cfg.fsdp
        keys = {k["key"] for k in rec["top_collectives"]}
        assert "pod/broadcast/grad/uint16" in keys
        assert not any(k.startswith("pod/") and "float32" in k and "loss" not in k
                       for k in keys)
        assert 0 < rec["ef_bytes"] < rec["param_bytes"] * 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_linear_write_equals_the_masked_one_and_traces(dtype):
    """The linear writes' scatter without its mask (``dense``: every slot
    in range, the capacity checked on the host) stores what the masked
    scatter stores, and runs on fake tensors, where the mask's host sync
    (``torch.nonzero``) cannot: hymba's prefill cells reach it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rng = np.random.default_rng(1)
    arena = torch.from_numpy(rng.standard_normal((4, 6, 2, 3)).astype(np.float32)).to(dtype)
    rows = torch.from_numpy(rng.standard_normal((4, 2, 3)).astype(np.float32)).to(dtype)
    slots = torch.arange(4) * 6 + 5
    a, b = arena.clone(), arena.clone()
    posit_codec.scatter_slots([(a, rows)], slots)
    posit_codec.scatter_slots([(b, rows)], slots, dense=True)
    assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       b.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    mode = FakeTensorMode()
    fa, fr, fs = (mode.from_tensor(t) for t in (arena, rows, slots))
    with mode:
        posit_codec.scatter_slots([(fa, fr)], fs, dense=True)
