"""The port's sharding rule table, cache specs, mesh and shards against
the reference's ``runtime/sharding.py`` and ``launch/mesh.py``.

The port's counterpart of ``tests/test_sharding_rules.py``, on the CPU
with no spawn: every parameter path of every architecture matches a
rule; each placement is the reference's with its layer-stack axis
dropped (the port's per-layer lists are unstacked), except the
deliberate divergences ``sharding.DIVERGENCES`` that ROADMAP.md lists
(MLA's query path, rwkv6's ``cm_wr``); ``filter_spec``,
``paged_cache_specs`` and ``cache_specs`` (every ``ARCH_ID``'s linear
cache) pin the same goldens, and the engine's head-split caches differ
from ``cache_specs`` only on ``CACHE_DIVERGENCES``; ``make_host_mesh``
rounds a non-dividing degree down with the warning.  Beyond the
reference: the per-group split decisions (whole heads, experts,
vocabulary rows; hymba's attention and SSM heads together), the shards
of every transformer lane and of hymba, rwkv6 and whisper reassembling
the single-device weights (hymba's segmented ``in_proj`` through
``unshard``, bit for bit), and the identity at mp 1.
"""
import dataclasses
import re
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from repro import configs as RCFG
from repro.models import get_family as ref_family
from repro.runtime import sharding as RS
from repro_torch import configs as TCFG
from repro_torch import tree
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_family
from repro_torch.runtime import sharding as S
from repro_torch.runtime.engine import Engine


class _FakeMesh:
    """Duck-typed mesh for spec goldens (``axis_names`` and ``shape``),
    as the reference's test uses."""
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 4}


class _RankMesh:
    """A ``DeviceMesh`` stand-in for one rank of a ``(1, mp)`` mesh: what
    ``shard_params`` and ``tensor_parallel`` read, no process group."""
    mesh_dim_names = ("data", "model")

    def __init__(self, mp, rank):
        self.mp, self.rank = mp, rank

    def size(self, i=None):
        return (1, self.mp)[i]

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return self.rank


def _ref_leaves(arch):
    cfg = RCFG.get_config(arch).reduced(compute_dtype="float32")
    shapes = jax.eval_shape(lambda k: ref_family(cfg).init_params(k, cfg),
                            jax.random.PRNGKey(0))
    return {RS._path_str(p): tuple(x.shape)
            for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]}


def _port_leaves(arch):
    cfg = TCFG.get_config(arch).reduced(compute_dtype="float32")
    params = get_family(cfg).init_params(cfg, seed=0, device="cpu")
    return {p: tuple(x.shape) for p, x in tree.leaves_with_paths(params)}


def _stacked(path):
    """The reference's path of a port leaf: the layer index dropped."""
    return re.sub(r"/\d+(?=/|$)", "", path, count=1)


@pytest.mark.parametrize("arch", TCFG.ARCH_IDS)
def test_every_param_path_matches_a_rule(arch):
    missing = [p for p in _port_leaves(arch) if S.match_for_path(p) is None]
    assert not missing, f"{arch}: param paths with no sharding rule: {missing}"


@pytest.mark.parametrize("arch", TCFG.ARCH_IDS)
def test_placement_is_the_reference_with_the_layer_axis_dropped(arch):
    ref, port = _ref_leaves(arch), _port_leaves(arch)
    assert {_stacked(p) for p in port} == set(ref)
    diverged = set()
    for path, shape in port.items():
        rpath = _stacked(path)
        want = tuple(RS.spec_for_path(rpath, len(ref[rpath])))
        if rpath != path:                          # a per-layer leaf
            assert ref[rpath][1:] == shape
            want = want[1:]
        got = S.spec_for_path(path, len(shape))
        pat = S.match_for_path(path)[0]
        if pat in S.DIVERGENCES:
            diverged.add(pat)
            continue
        assert got == want, (path, got, want)
    cfg = TCFG.get_config(arch)
    want = {r"layers.*/wdq/w$", r"layers.*/wuq/w$"} if cfg.mla else \
        {r"layers.*/cm_wr/w$"} if cfg.family == "rwkv6" else set()
    assert diverged == want and want <= set(S.DIVERGENCES)
    if cfg.mla:
        assert S.spec_for_path("layers/0/attn/wdq/w", 2) == (None, None)
        assert S.spec_for_path("layers/0/attn/wuq/w", 2) == (None, "model")
    if cfg.family == "rwkv6":
        assert S.spec_for_path("layers/0/cm_wr/w", 2) == (None, None)
        assert S.spec_for_path("layers/0/cm_wk/w", 2) == (None, "model")


def test_match_for_path_can_miss():
    assert S.match_for_path("no/such/param") is None


def test_filter_spec_replicates_a_dim_that_does_not_divide():
    assert S.filter_spec(("model", None), (8, 3), _FakeMesh()) == ("model", None)
    assert S.filter_spec(("model", None), (6, 3), _FakeMesh()) == (None, None)
    assert S.filter_spec(("pod", "model"), (8, 8), _FakeMesh()) == (None, "model")
    assert S.filter_spec((None,), (5, 4), _FakeMesh()) == (None, None)
    for spec, shape in ((("model", None), (6, 3)), ((None, "model"), (4, 12))):
        assert S.filter_spec(spec, shape, _FakeMesh()) == tuple(
            RS.filter_spec(RS.P(*spec), shape, _FakeMesh()))


def _tcfg():
    return TCFG.get_config("phi3-medium-14b").reduced(compute_dtype="float32")


def test_paged_cache_spec_shards_head_axis():
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt)      # noqa: E731
    specs = S.paged_cache_specs(
        {"k": z(2, 8, 4, 4, 8), "v": z(2, 8, 4, 4, 8), "c_kv": z(2, 8, 4, 6),
         "k_rope": z(2, 8, 4, 8), "block_tables": z(3, 5, dt=torch.int32),
         "lens": z(3, dt=torch.int32), "max_len": 32}, _FakeMesh(), _tcfg())
    assert specs["k"] == specs["v"] == (None, None, None, "model", None)
    for name in ("c_kv", "k_rope", "block_tables", "lens", "max_len"):
        assert all(e is None for e in specs[name]), name
    # 2 KV heads on a 'model' = 4 mesh replicate
    specs = S.paged_cache_specs({"k": z(2, 8, 4, 2, 8)}, _FakeMesh(), _tcfg())
    assert all(e is None for e in specs["k"])


@pytest.fixture
def one_rank_world(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_host_mesh_rounds_down_and_warns(one_rank_world):
    with pytest.warns(UserWarning, match="rounding down"):
        mesh = make_host_mesh(4)
    assert S.axis_sizes(mesh) == {"data": 1, "model": 1}


def test_make_host_mesh_exact_degree_is_silent(one_rank_world):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        mesh = make_host_mesh(1)
    assert not [x for x in w if "rounding down" in str(x.message)]
    assert S.axis_sizes(mesh)["model"] == 1
    assert S.tensor_parallel(_tcfg(), mesh) is None      # mp 1: no plan


def _lane_cfg(arch, **over):
    return dataclasses.replace(TCFG.get_config(arch).reduced(compute_dtype="float32"),
                               **over)


@pytest.mark.parametrize("arch,mp,over,want", [
    ("phi3-medium-14b", 2, {}, dict(attn=True, kv=True, mlp=True, vocab=True)),
    # 2 KV heads at mp 4: the attention runs whole on every rank
    ("phi3-medium-14b", 4, {}, dict(attn=False, kv=False, mlp=True, vocab=True)),
    # MQA: the query heads split, the one KV head replicates
    ("granite-34b", 2, {}, dict(attn=True, kv=False, mlp=True, vocab=True)),
    ("minicpm3-4b", 2, {}, dict(attn=True, kv=False, mlp=True, vocab=True)),
    # an odd vocabulary replicates the embedding and the head
    ("granite-moe-3b-a800m", 2, {"vocab": 257},
     dict(attn=True, kv=True, mlp=False, moe=True, vocab=False)),
    ("granite-moe-3b-a800m", 8, {}, dict(attn=False, kv=False, moe=False, vocab=True)),
])
def test_split_groups(arch, mp, over, want):
    tp = S.tensor_parallel(_lane_cfg(arch, **over), _RankMesh(mp, 0))
    assert {k: getattr(tp, k) for k in want} == want


LANE_CFGS = {"dense": ("phi3-medium-14b", {}), "mla": ("minicpm3-4b", {}),
             "mqa": ("granite-34b", {}), "moe": ("granite-moe-3b-a800m", {"vocab": 257}),
             "gemma": ("gemma-7b", {}), "heads-4x4": ("phi3-medium-14b",
                                                      {"n_heads": 4, "n_kv_heads": 4})}


@pytest.mark.parametrize("lane", LANE_CFGS)
@pytest.mark.parametrize("mp", [2, 4])
def test_shards_reassemble_the_weights(lane, mp):
    """Each rank's shard is a contiguous slice along the rule's dim (or
    the whole leaf); the ranks' slices concatenate to the single-device
    leaf; shapes agree with the rank-local config's; sharding twice
    changes nothing; a layer drawn with ``init_params(shard=)`` equals
    the slice of the single-device draw."""
    arch, over = LANE_CFGS[lane]
    cfg = _lane_cfg(arch, **over)
    params = T.init_params(cfg, seed=3, device="cpu")
    shards = [S.shard_params(params, _RankMesh(mp, r), cfg) for r in range(mp)]
    for (path, full), *parts in zip(tree.leaves_with_paths(params),
                                    *(tree.leaves(s) for s in shards)):
        spec = S.leaf_spec(path, tuple(full.shape), _RankMesh(mp, 0), cfg)
        if "model" in spec:
            torch.testing.assert_close(torch.cat(parts, spec.index("model")), full,
                                       rtol=0, atol=0)
        else:
            assert all(p is full for p in parts), path
    tp = S.tensor_parallel(cfg, _RankMesh(mp, 1))
    local = S.local_config(cfg, tp)
    want = T.init_params(local, seed=3, device="cpu")
    for (path, got), ref in zip(tree.leaves_with_paths(shards[1]), tree.leaves(want)):
        if not re.search(r"(tok_embed|lm_head/w|moe/(wi|wg|wo))$", path):
            assert got.shape == ref.shape, path
    assert tree.leaves(S.shard_params(shards[1], _RankMesh(mp, 1), cfg)) == \
        tree.leaves(shards[1])
    drawn = T.init_params(cfg, seed=3, device="cpu", shard=lambda t, prefix: S.shard_params(
        t, _RankMesh(mp, 1), cfg, prefix))
    for a, b in zip(tree.leaves(drawn), tree.leaves(shards[1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_no_mesh_changes_nothing():
    cfg = _tcfg()
    params = T.init_params(cfg, seed=0, device="cpu")
    assert S.shard_params(params, None, cfg) is params
    assert S.tensor_parallel(cfg, None) is None
    assert S.shard_params(params, _RankMesh(1, 0), cfg) is params
    eng = Engine(cfg, params, max_len=16, paged=True, device="cpu")
    assert eng.tp is None and eng.cfg is cfg and eng.params is params
    assert eng.cache_shards() == {}
    assert eng.init_cache(2)["k"].shape == T.init_paged_cache(
        cfg, 2, 16, 16, 2 * eng.table_width, device="cpu")["k"].shape


def test_other_families_refuse_a_mesh():
    """hymba, rwkv6 and whisper take a mesh since tensor parallelism
    covers them: their groups split on whole heads (hymba's attention and
    SSM heads together, and only where its KV heads divide or are one),
    ``d_ff`` and vocabulary rows, at full width as at reduced."""
    full = {a: TCFG.get_config(a) for a in ("hymba-1.5b", "rwkv6-7b", "whisper-tiny")}
    cases = [  # config, mp, the split groups
        (_lane_cfg("rwkv6-7b"), 2, dict(attn=True, kv=False, mlp=True, vocab=True)),
        (full["rwkv6-7b"], 2, dict(attn=True, kv=False, mlp=True, vocab=True)),
        (_lane_cfg("whisper-tiny"), 2, dict(attn=True, kv=True, mlp=True, vocab=True)),
        (full["whisper-tiny"], 2, dict(attn=True, kv=True, mlp=True, vocab=False)),
        (_lane_cfg("hymba-1.5b"), 2, dict(attn=True, kv=True, mlp=True, vocab=True)),
        # 2 KV heads at mp 4: attention and SSM heads whole, MLP and vocabulary split
        (_lane_cfg("hymba-1.5b"), 4, dict(attn=False, kv=False, mlp=True, vocab=True)),
        # full width: 25 heads, 5 KV heads, 25 SSM heads split at mp 5 (not
        # its MLP, 5 504, nor its vocabulary, 32 001); at mp 2 the MLP only
        (full["hymba-1.5b"], 5, dict(attn=True, kv=True, mlp=False, vocab=False)),
        (full["hymba-1.5b"], 2, dict(attn=False, kv=False, mlp=True, vocab=False)),
        # one KV head: the SSM and query heads split, K/V whole
        (_lane_cfg("hymba-1.5b", n_kv_heads=1), 2, dict(attn=True, kv=False, mlp=True)),
    ]
    for cfg, mp, want in cases:
        tp = S.tensor_parallel(cfg, _RankMesh(mp, 0))
        assert {k: getattr(tp, k) for k in want} == want, (cfg.name, mp)
        local = S.local_config(cfg, tp)
        if cfg.family == "hymba":
            assert local.ssm_heads == (cfg.ssm_heads // mp if tp.attn else cfg.ssm_heads)


@pytest.mark.parametrize("lane", LANE_CFGS)
@pytest.mark.parametrize("mp", [2, 4])
def test_rank_arena_is_its_share_of_the_whole_cache(lane, mp):
    """Each rank allocates only its own paged cache (``Engine.init_cache``
    on the rank-local config): every leaf has the shape of its share of
    the whole cache under the reference's ``paged_cache_specs`` (the KV
    heads split where they divide, MLA latents and metadata whole), the
    metadata equal the whole cache's, and ``cache_shards`` names exactly
    the leaves those specs split."""
    arch, over = LANE_CFGS[lane]
    cfg = _lane_cfg(arch, **over)
    params = T.init_params(cfg, seed=0, device="cpu")
    whole = T.init_paged_cache(cfg, 2, 16, 4, 8, device="cpu")
    for rank in range(mp):
        eng = Engine(cfg, params, max_len=16, paged=True, block_size=4, n_blocks=8,
                     device="cpu", mesh=_RankMesh(mp, rank))
        specs = S.paged_cache_specs(whole, _RankMesh(mp, rank), cfg)
        got = eng.init_cache(2)
        assert set(got) == set(whole)
        for key, x in whole.items():
            if not isinstance(x, torch.Tensor):
                assert got[key] == x, key
                continue
            want = tuple(n // mp if e == "model" else n for n, e in zip(x.shape, specs[key]))
            assert tuple(got[key].shape) == want, (key, specs[key])
            if key in ("block_tables", "lens"):
                assert torch.equal(got[key], x), key
        assert eng.cache_shards() == {k: mp for k, spec in specs.items() if "model" in spec}


def test_cache_report_counts_the_whole_cache_and_one_rank():
    from repro_torch.compress.kvcache import cache_report

    cfg = _tcfg()
    whole = T.init_paged_cache(cfg, 2, 16, 4, 8, device="cpu")
    local = dict(whole, k=whole["k"][:, :, :, :1], v=whole["v"][:, :, :, :1])
    one, two = cache_report(whole), cache_report(local, shards={"k": 2, "v": 2})
    assert one["per_device_bytes"] == one["bytes"] == two["bytes"]
    arena = whole["k"].numel() * 4 * 2
    assert two["per_device_bytes"] == one["bytes"] - arena // 2
    assert two["f32_bytes"] == one["f32_bytes"]
    np.testing.assert_allclose(two["ratio"], one["ratio"])


FAMILIES = {"hymba": ("hymba-1.5b", {}), "rwkv6": ("rwkv6-7b", {}),
            "whisper": ("whisper-tiny", {}), "hymba-mqa": ("hymba-1.5b", {"n_kv_heads": 1})}


def _gather_stub(shards):
    """A stand-in for ``collectives.gather_axis`` over stand-in ranks: the
    ranks' pieces of the leaf being gathered, stacked (the one-rank view
    of what the broadcasts deliver)."""
    def gather_axis(t, mesh, axis, what="grad"):
        pieces = [p for p in shards if p.shape == t.shape and torch.equal(p, t)]
        assert pieces, "the gathered piece is not a rank's"
        i = next(i for i, p in enumerate(shards) if p is pieces[0])
        assert i == mesh.rank
        return torch.stack(shards)
    return gather_axis


@pytest.mark.parametrize("lane", FAMILIES)
@pytest.mark.parametrize("mp", [2, 4])
def test_family_shards_reassemble_the_weights(lane, mp, monkeypatch):
    """hymba, rwkv6 and whisper: each rank's shard of each leaf is its
    piece along the executed placement (hymba's ``in_proj`` by
    :class:`Segments`: its SSM heads' xs, gate and dt, B and C whole);
    ``unshard`` of every rank's piece gives the whole leaf bit for bit;
    shapes are the rank-local config's; ``init_params(shard=)`` draws the
    slice of the single-device draw; leaves whose group does not split
    stay whole."""
    arch, over = FAMILIES[lane]
    cfg = _lane_cfg(arch, **over)
    fam = get_family(cfg)
    params = fam.init_params(cfg, seed=3, device="cpu")
    meshes = [_RankMesh(mp, r) for r in range(mp)]
    shards = [S.shard_params(params, m, cfg) for m in meshes]
    tp = S.tensor_parallel(cfg, meshes[1])
    local_shapes = {p: tuple(x.shape) for p, x in tree.leaves_with_paths(
        fam.init_params(S.local_config(cfg, tp), seed=3, device="cpu"))}
    n_split = 0
    for (path, full), *parts in zip(tree.leaves_with_paths(params),
                                    *(tree.leaves(s) for s in shards)):
        spec = S.leaf_spec(path, tuple(full.shape), meshes[0], cfg)
        sh = S.NamedSharding(meshes[1], spec)
        torch.testing.assert_close(sh.shard(full), parts[1], rtol=0, atol=0)
        if all(e is None for e in spec):
            assert all(p is full for p in parts), path
            continue
        n_split += 1
        monkeypatch.setattr(S, "gather_axis", _gather_stub(parts))
        monkeypatch.setattr(S, "gather_dim", lambda t, dim, mesh, axis, _p=parts:
                            torch.cat(_p, dim))
        whole = S.unshard(parts[1], sh)
        assert whole.dtype == full.dtype and torch.equal(whole, full), path
        if not re.search(r"(tok_embed|lm_head/w)$", path):
            assert tuple(parts[1].shape) == local_shapes[path], path
    assert n_split > 0
    drawn = fam.init_params(cfg, seed=3, device="cpu", shard=lambda t, prefix: S.shard_params(
        t, meshes[1], cfg, prefix))
    for a, b in zip(tree.leaves(drawn), tree.leaves(shards[1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tree.leaves(S.shard_params(shards[1], meshes[1], cfg)) == tree.leaves(shards[1])


def test_in_proj_segments():
    """hymba's ``in_proj`` (d, 2 d_in + 2 n + hs) at mp 2: a rank holds
    its half of xs, gate and dt and the whole B and C, in that order."""
    cfg = _lane_cfg("hymba-1.5b")
    d_in, n, hs = cfg.ssm_heads * cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_heads
    spec = S.leaf_spec("layers/0/in_proj/w", (cfg.d_model, 2 * d_in + 2 * n + hs),
                       _RankMesh(2, 0), cfg)
    seg = spec[1]
    assert spec[0] is None and isinstance(seg, S.Segments)
    cols = torch.arange(2 * d_in + 2 * n + hs)[None, :]
    h = d_in // 2
    want = torch.cat([torch.arange(h, d_in), torch.arange(d_in + h, 2 * d_in),
                      torch.arange(2 * d_in, 2 * d_in + 2 * n),
                      torch.arange(2 * d_in + 2 * n + hs // 2, 2 * d_in + 2 * n + hs)])
    assert torch.equal(seg.take(cols, 1, 1, 2)[0], want)
    assert seg.local_size(2) == want.numel()
    stacked = torch.stack([seg.take(cols, 1, r, 2) for r in range(2)])
    assert torch.equal(seg.join(stacked, 1), cols)
    assert not S.split_leaves({"layers": [{"in_proj": {"w": torch.zeros(1, 1)}}]},
                              _lane_cfg("phi3-medium-14b"), None)[0]


def _ref_cache(cache):
    """A port cache as the reference's ``cache_specs`` walks it: shapes,
    Python ints as 0-d arrays."""
    return {k: (jax.ShapeDtypeStruct(tuple(x.shape), np.float32) if isinstance(x, torch.Tensor)
                else np.int32(x)) for k, x in cache.items()}


def _model_dim(spec):
    """The dim of a spec that ``"model"`` splits (alone or with another
    axis), or None."""
    return next((i for i, e in enumerate(spec)
                 if e == "model" or (isinstance(e, tuple) and "model" in e)), None)


def _engine_cache_specs(cache, cfg):
    """The engine's placement of ``cache`` at mp 2: each leaf of
    ``cache_split_leaves`` on its head axis (K/V ``(.., G, hd)``, the
    states ``(L, B, H, ...)``), every other leaf whole."""
    split = S.cache_split_leaves(cfg.family, S.tensor_parallel(cfg, _RankMesh(2, 0)))
    out = {}
    for key, x in cache.items():
        spec = [None] * (x.dim() if isinstance(x, torch.Tensor) else 0)
        if key in split:
            spec[2 if key in ("wkv", "ssm") else 3] = "model"
        out[key] = tuple(spec)
    return out


class _CacheMesh(_FakeMesh):
    shape = {"data": 2, "model": 2}


@pytest.mark.parametrize("arch", TCFG.ARCH_IDS)
@pytest.mark.parametrize("seq", [False, True])
def test_cache_specs_are_the_reference(arch, seq):
    """``cache_specs`` on every ``ARCH_ID``'s linear cache equals the
    reference's (the sequence axis over ``"model"``, the states by heads,
    the batch over ``"data"``); the engine's own placement moves
    ``"model"`` only on ``CACHE_DIVERGENCES`` (K/V to their heads, MLA's
    latents whole), and each leaf it splits holds the rank-local
    config's share."""
    cfg = _lane_cfg(arch)
    fam = get_family(cfg)
    cache = fam.init_cache(cfg, 4, 32, device="cpu")
    mesh = _CacheMesh()
    got = S.cache_specs(cache, mesh, cfg, seq_axis_shard=seq)
    want = RS.cache_specs(_ref_cache(cache), mesh, cfg, seq_axis_shard=seq)
    assert set(got) == set(want)
    for key in cache:
        assert got[key] == tuple(want[key]), (key, got[key], want[key])
    engine = _engine_cache_specs(cache, cfg)
    moved = {k for k in cache if _model_dim(engine[k]) != _model_dim(got[k])}
    assert moved <= set(S.CACHE_DIVERGENCES)
    assert moved == {k for k in cache if k in S.CACHE_DIVERGENCES and cache[k].dim() > 0}
    local = fam.init_cache(S.local_config(cfg, S.tensor_parallel(cfg, _RankMesh(2, 0))), 4, 32,
                           device="cpu")
    for key, x in cache.items():
        if isinstance(x, torch.Tensor):
            shape = [n // 2 if e == "model" else n for n, e in zip(x.shape, engine[key])]
            assert list(local[key].shape) == shape, key
