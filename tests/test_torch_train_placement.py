"""The data-parallel placement functions against the reference's
``runtime/sharding.py``: ``param_specs(fsdp=True, n_data=)``,
``batch_axes`` and ``batch_specs``, on every ``ARCH_ID``'s reduced
parameters, with the reference's layer-stack axis mapped as
``tests/test_torch_sharding.py`` maps it.  Where the reference's ZeRO
axis lands on its layer-stack axis (the data size divides the layer
count), the port's unstacked leaf takes its own first free dim instead:
``sharding.FSDP_DIVERGENCES``, which ROADMAP.md lists, and the test
names each such leaf.  Then the port's own: the rows a rank holds
(row-major over ``("pod", "data")``, as the reference's batch spec
places them), ``param_shardings`` (the executed placement under a
``"model"`` axis that splits, on parameters and on the optimizer
state), a train step for every family at a ``"model"`` axis of 1 and
of 2, the leaves whose gradient a rank holds only a part of
(``partial_grad_leaves``) and the leaves it holds a slice of
(``split_leaves``, hymba's ``in_proj`` segment by segment), and the
gradient norm over such shares.
"""
import re

import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from repro import configs as RCFG
from repro.models import get_family as ref_family
from repro.runtime import sharding as RS
from repro_torch import configs as TCFG
from repro_torch import tree
from repro_torch.models.registry import get_family
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as S
from repro_torch.runtime import train_loop


class _FakeMesh:
    """Duck-typed mesh (``axis_names`` and ``shape``) as the reference's
    tests use, with a rank's coordinates for ``batch_rows``."""

    def __init__(self, **sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)
        self.coords = {a: 0 for a in sizes}

    def get_local_rank(self, name):
        return self.coords[name]


def _ref_leaves(arch):
    cfg = RCFG.get_config(arch).reduced(compute_dtype="float32")
    shapes = jax.eval_shape(lambda k: ref_family(cfg).init_params(k, cfg),
                            jax.random.PRNGKey(0))
    return shapes, {RS._path_str(p): tuple(x.shape)
                    for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]}


def _port_params(arch):
    cfg = TCFG.get_config(arch).reduced(compute_dtype="float32")
    return cfg, get_family(cfg).init_params(cfg, seed=0, device="cpu")


def _specs(spec_tree, params) -> dict:
    """``{path: spec}`` of a spec tree shaped like ``params`` (a spec is a
    tuple, which the tree walk would descend into)."""
    out = {}
    for path, _ in tree.leaves_with_paths(params):
        t = spec_tree
        for k in path.split("/"):
            t = t[int(k)] if isinstance(t, list) else t[k]
        out[path] = t
    return out


def _stacked(path):
    """The reference's path of a port leaf: the layer index dropped."""
    return re.sub(r"/\d+(?=/|$)", "", path, count=1)


@pytest.mark.parametrize("n_data", [2, 4])
@pytest.mark.parametrize("arch", TCFG.ARCH_IDS)
def test_fsdp_param_specs_are_the_reference_with_the_layer_axis_dropped(arch, n_data):
    """At data 2 the reduced models' 2 layers take the reference's ZeRO
    axis on their stack: every per-layer leaf diverges, as recorded; at
    data 4 none does."""
    mesh = _FakeMesh(data=n_data, model=2)
    shapes, ref_shapes = _ref_leaves(arch)
    ref_specs = {RS._path_str(p): tuple(s) for p, s in jax.tree_util.tree_flatten_with_path(
        RS.param_specs(shapes, mesh, fsdp=True, n_data=n_data),
        is_leaf=lambda x: isinstance(x, P))[0]}
    cfg, params = _port_params(arch)
    port = _specs(S.param_specs(params, mesh, fsdp=True, n_data=n_data), params)
    shapes_port = {p: tuple(x.shape) for p, x in tree.leaves_with_paths(params)}
    diverged, compared = [], []
    for path, got in port.items():
        rpath = _stacked(path)
        want = ref_specs[rpath] + (None,) * (len(ref_shapes[rpath]) - len(ref_specs[rpath]))
        hit = S.match_for_path(path)
        if hit is not None and hit[0] in S.DIVERGENCES:     # MLA's query path
            continue
        compared.append(path)
        if rpath != path:                          # a per-layer leaf
            if want[0] == "data":
                assert any(re.search(pat, path) for pat in S.FSDP_DIVERGENCES), path
                assert cfg.n_layers % n_data == 0
                unstacked = S.filter_spec(S.spec_for_path(path, len(shapes_port[path])),
                                          shapes_port[path], mesh)
                assert got == S._add_fsdp_axis(unstacked, shapes_port[path], n_data), path
                diverged.append(path)
                continue
            want = want[1:]
        assert got == want, (path, got, want)
    n_layer_leaves = sum(_stacked(p) != p for p in compared)
    assert len(diverged) == (n_layer_leaves if cfg.n_layers % n_data == 0 else 0), diverged


@pytest.mark.parametrize("arch", TCFG.ARCH_IDS)
def test_param_specs_without_fsdp_are_the_rule_table(arch):
    mesh = _FakeMesh(data=2, model=2)
    _, params = _port_params(arch)
    shapes = dict(tree.leaves_with_paths(params))
    for path, spec in _specs(S.param_specs(params, mesh), params).items():
        shape = shapes[path].shape
        assert spec == S.filter_spec(S.spec_for_path(path, len(shape)), shape, mesh)
    assert S.param_specs(params, mesh, fsdp=True, n_data=1) == S.param_specs(params, mesh)


MESHES = [dict(data=4, model=2), dict(pod=2, data=2, model=2), dict(data=1, model=8),
          dict(pod=2, data=1, model=1), dict(model=4)]


@pytest.mark.parametrize("sizes", MESHES, ids=lambda m: "x".join(f"{k}{v}" for k, v in m.items()))
@pytest.mark.parametrize("batch", [1, 4, 6, 8])
def test_batch_axes_and_specs_match_reference(sizes, batch):
    mesh = _FakeMesh(**sizes)
    want = RS.batch_axes(batch, mesh)
    assert S.batch_axes(batch, mesh) == want
    leaves = {"tokens": torch.zeros((batch, 16), dtype=torch.int32),
              "frames": torch.zeros((batch, 8, 4))}
    ref = RS.batch_specs({k: jax.ShapeDtypeStruct(tuple(v.shape), "float32")
                          for k, v in leaves.items()}, mesh, None)
    got = S.batch_specs(leaves, mesh)

    def norm(spec):          # ``P`` keeps a one-axis tuple as the axis itself
        return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)
    assert {k: tuple(v) for k, v in ref.items()} == {k: norm(v) for k, v in got.items()}


@pytest.mark.parametrize("sizes", MESHES, ids=lambda m: "x".join(f"{k}{v}" for k, v in m.items()))
def test_batch_rows_are_row_major_over_pod_and_data(sizes):
    """Rank (p, d, m) holds block ``p * n_data + d`` of the rows, the
    block the reference's ``P(("pod", "data"))`` gives that device;
    every row is held, ``"model"`` ranks hold the same rows."""
    mesh = _FakeMesh(**sizes)
    n_pod, n_data = sizes.get("pod", 1), sizes.get("data", 1)
    held = set()
    for p in range(n_pod):
        for d in range(n_data):
            for m in range(sizes.get("model", 1)):
                mesh.coords.update({k: v for k, v in (("pod", p), ("data", d), ("model", m))
                                    if k in sizes})
                r0, r1 = S.batch_rows(8, mesh)
                per = 8 // (n_pod * n_data)
                assert (r0, r1) == ((p * n_data + d) * per, (p * n_data + d + 1) * per)
                held |= set(range(r0, r1))
                rows = S.batch_slice({"tokens": torch.arange(8)[:, None]}, mesh)["tokens"]
                assert rows[:, 0].tolist() == list(range(r0, r1))
    assert held == set(range(8))
    mesh.coords = {a: 0 for a in sizes}
    assert S.batch_rows(6, _FakeMesh(data=4)) == (0, 6)      # 4 does not divide 6


class _RankMesh(_FakeMesh):
    """``sharding.tensor_parallel``'s view of a ``(1, mp)`` mesh."""
    mesh_dim_names = ("data", "model")

    def __init__(self, mp):
        super().__init__(data=1, model=mp)

    def size(self, i=None):
        return (1, self.shape["model"])[i]

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return 0


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "minicpm3-4b", "granite-34b",
                                  "granite-moe-3b-a800m", "gemma-7b"])
def test_param_shardings_are_the_executed_placement(arch):
    """With ``cfg`` and ``"model"`` 2: each leaf's spec is ``leaf_spec`` on
    its whole shape, for parameters given whole or as a rank's shard and
    for the optimizer state's ``m``/``v`` (``count`` whole), and a
    shard is the whole leaf cut by that spec."""
    cfg, params = _port_params(arch)
    mesh = _RankMesh(2)
    local = S.shard_params(params, mesh, cfg)
    whole_specs = [S.leaf_spec(p, tuple(x.shape), mesh, cfg)
                   for p, x in tree.leaves_with_paths(params)]
    for t in (params, local):
        got = [sh.spec for sh in tree.leaves(S.param_shardings(t, mesh, cfg=cfg))]
        assert got == whole_specs
    opt = adamw.init(local, adamw.AdamWConfig(posit_moments=True))
    shard = S.param_shardings(opt, mesh, cfg=cfg)
    assert [s.spec for s in tree.leaves(shard["m"])] == whole_specs
    assert [s.spec for s in tree.leaves(shard["v"])] == whole_specs
    assert shard["count"].spec == ()
    assert any("model" in s for s in whole_specs)
    for x, y, sh in zip(tree.leaves(params), tree.leaves(local),
                        tree.leaves(S.param_shardings(params, mesh, cfg=cfg))):
        assert torch.equal(sh.shard(x), y)
    assert S.split_leaves(local, cfg, mesh) == ["model" in s for s in whole_specs]


@pytest.mark.parametrize("arch", TCFG.ARCH_IDS)
def test_model_axis_of_one_is_allowed_for_every_family(arch):
    """A ``"model"`` axis of 1 trains every family on the single-device
    path; at 2 every family has a plan, and its train step builds (the
    partial gradients of the leaves a rank slices are summed:
    ``sharding.partial_grad_leaves``)."""
    cfg = TCFG.get_config(arch).reduced(compute_dtype="float32")
    assert S.tensor_parallel(cfg, _RankMesh(1)) is None
    train_loop.make_train_step(cfg, adamw.AdamWConfig(), mesh=_RankMesh(1))
    tp = S.tensor_parallel(cfg, _RankMesh(2))
    assert tp.size == 2 and tp.vocab and (tp.attn or tp.moe)
    train_loop.make_train_step(cfg, adamw.AdamWConfig(), mesh=_RankMesh(2))


# the leaves of a layer whose gradient each rank holds a part of where
# their group splits (``sharding.partial_grad_leaves``)
_PARTIAL = {"hymba-1.5b": ("A_log", "D", "attn_norm/scale", "dt_bias", "in_proj/w",
                           "ssm_norm/scale"),
            "rwkv6-7b": ("ln_x/bias", "ln_x/scale", "u", "w0", "wl_b"),
            "granite-moe-3b-a800m": ("moe/router/w",)}


@pytest.mark.parametrize("arch,mp", [("hymba-1.5b", 2), ("hymba-1.5b", 4), ("rwkv6-7b", 2),
                                     ("whisper-tiny", 2), ("granite-moe-3b-a800m", 2),
                                     ("gemma-7b", 2)])
def test_partial_and_split_leaves(arch, mp):
    """Per family and mesh: the partial leaves are the per-head leaves a
    rank slices (and the MoE router), and only where their group splits
    (hymba at 4 splits no heads: none); none of them is split.  A split
    leaf is one ``leaf_spec`` splits; hymba's ``in_proj`` is ``(1,
    Segments)`` in both lists where its heads split (its ``xs``, ``gate``
    and ``dt`` columns a rank's own, its ``B`` and ``C`` whole and partial)."""
    cfg, params = _port_params(arch)
    mesh = _RankMesh(mp)
    tp = S.tensor_parallel(cfg, mesh)
    local = S.shard_params(params, mesh, cfg)
    paths = [p for p, _ in tree.leaves_with_paths(local)]
    partial = dict(zip(paths, S.partial_grad_leaves(local, cfg, tp)))
    split = dict(zip(paths, S.split_leaves(local, cfg, mesh)))
    heads = tp.attn or cfg.family == "transformer"
    want = {f"layers/{i}/{leaf}" for i in range(cfg.n_layers)
            for leaf in _PARTIAL.get(arch, ())} if heads else set()
    assert {p for p, v in partial.items() if v} == want
    for path, x in tree.leaves_with_paths(params):
        spec = S.leaf_spec(path, tuple(x.shape), mesh, cfg)
        seg = [e for e in spec if isinstance(e, S.Segments)]
        if seg:
            assert split[path] == partial[path] == (1, seg[0])
            assert [sp for _, sp in seg[0].pieces(dict(tree.leaves_with_paths(local))[path],
                                                  1, mp)] == [True, False, True]
        else:
            assert split[path] is ("model" in spec), path
            assert not (split[path] and partial[path]), path
    assert (arch == "hymba-1.5b" and mp == 4) == (not any(split.values()) or not tp.attn)


class _SumTP:
    """A ``TensorParallel`` stand-in for the gradient norm of two ranks'
    shares: it records each rank's local sum, then returns their total."""
    size = 2

    def __init__(self, total=None):
        self.total, self.seen = total, []

    def all_reduce(self, x, what="activation"):
        self.seen.append(x.clone())
        return x if self.total is None else self.total.clone()


def test_global_norm_of_segments_leaves_is_the_whole_leafs():
    """The gradient norm over two ranks' shares of hymba's ``in_proj``
    (``Segments``), a split leaf and a replicated one: the split segments'
    and the split leaf's squares summed over the ranks, the whole ``B`` and
    ``C`` columns and the replicated leaf counted once, equals one
    device's norm of the whole leaves."""
    cfg = TCFG.get_config("hymba-1.5b").reduced(compute_dtype="float32")
    seg = S._in_proj_segments(cfg)
    gen = torch.Generator().manual_seed(3)
    whole = {"a": torch.randn(7, generator=gen),
             "in_proj": torch.randn(cfg.d_model, sum(seg.sizes), generator=gen),
             "wq": torch.randn(cfg.d_model, 64, generator=gen)}
    shares = [{"a": whole["a"], "in_proj": seg.take(whole["in_proj"], 1, r, 2),
               "wq": whole["wq"].narrow(1, 32 * r, 32)} for r in range(2)]
    split = [False, (1, seg), True]
    rec = _SumTP()
    for share in shares:
        adamw.global_norm(share, rec, split)
    total = rec.seen[0] + rec.seen[1]
    want = adamw.global_norm(whole)
    for share in shares:
        got = adamw.global_norm(share, _SumTP(total), split)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    # counting B and C on each rank as split would add them twice
    wrong, rec = [False, True, True], _SumTP()
    for share in shares:
        adamw.global_norm(share, rec, wrong)
    doubled = adamw.global_norm(shares[0], _SumTP(rec.seen[0] + rec.seen[1]), wrong)
    assert float(doubled) > float(want) * (1 + 1e-3)


class _DataModelMesh(_FakeMesh):
    """Rank ``(d, m)`` of a ``(data, model)`` mesh, as the placement reads
    it (no process group)."""
    mesh_dim_names = ("data", "model")

    def __init__(self, data, model, d=0, m=0):
        super().__init__(data=data, model=model)
        self.coords = {"data": d, "model": m}

    def size(self, i=None):
        return (self.shape["data"], self.shape["model"])[i]

    def get_group(self, name):
        return None


@pytest.mark.parametrize("arch", TCFG.ARCH_IDS)
def test_whole_shapes_are_the_parameters(arch):
    """``whole_shapes`` (the family's init under ``FakeTensorMode``) names
    every leaf of the parameters with its shape."""
    cfg, params = _port_params(arch)
    assert S.whole_shapes(cfg) == {p: tuple(x.shape) for p, x in tree.leaves_with_paths(params)}


@pytest.mark.parametrize("data,model", [(2, 1), (2, 2), (4, 1)])
@pytest.mark.parametrize("arch", ["phi3-medium-14b", "minicpm3-4b", "granite-moe-3b-a800m",
                                  "rwkv6-7b"])
def test_fsdp_pieces_and_their_placement(arch, data, model):
    """Under ``fsdp`` each rank's piece of each leaf (``shard_params``) is
    the whole leaf cut by its spec (``param_shardings``), which is the same
    from the whole tree, a rank's ``"model"`` shards and its pieces, and
    for the optimizer state's ``m`` and ``v``; ``"data"`` lands on a dim
    ``"model"`` leaves free; ``shard_params`` is idempotent, and
    ``fsdp_dims`` refuses a leaf left whole."""
    cfg, params = _port_params(arch)
    for d in range(data):
        for m in range(model):
            mesh = _DataModelMesh(data, model, d, m)
            local = S.shard_params(params, mesh, cfg)
            pieces = S.shard_params(params, mesh, cfg, fsdp=True)
            specs = [s.spec for s in tree.leaves(S.param_shardings(params, mesh, cfg=cfg,
                                                                   fsdp=True))]
            for t in (local, pieces):
                assert [s.spec for s in tree.leaves(S.param_shardings(
                    t, mesh, cfg=cfg, fsdp=True))] == specs
            assert sum("data" in s for s in specs) > len(specs) // 2
            for x, y, spec in zip(tree.leaves(params), tree.leaves(pieces), specs):
                assert torch.equal(S.NamedSharding(mesh, spec).shard(x), y)
                assert list(spec).count("data") <= 1
            assert all(torch.equal(a, b) for a, b in zip(
                tree.leaves(S.shard_params(pieces, mesh, cfg, fsdp=True)), tree.leaves(pieces)))
            assert S.fsdp_dims(pieces, mesh, cfg) == [
                s.index("data") if "data" in s else None for s in specs]
            opt = adamw.init(pieces, adamw.AdamWConfig(posit_moments=True))
            shard = S.param_shardings(opt, mesh, cfg=cfg, fsdp=True)
            assert [s.spec for s in tree.leaves(shard["m"])] == specs
            assert [s.spec for s in tree.leaves(shard["v"])] == specs
    with pytest.raises(ValueError, match="not this rank's piece"):
        S.fsdp_dims(S.shard_params(params, mesh, cfg), mesh, cfg)
