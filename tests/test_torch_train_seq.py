"""The sequence layout's premises and boundaries, without ranks.

* The reference's own premise: its single-device step is the same, bit
  for bit, with ``seq_shard_activations`` on and off (the flag only
  places activations under a mesh), which is what makes its one-device
  step the target of the port's sequence-layout lanes in
  ``tests/test_torch_train_ranks.py``.
* Serving never takes the layout: ``Engine(mesh=)`` and the schedulers
  over it build their plan with ``seq`` false for a config whose flag is
  on, while the training step's plan takes it in the families that have
  one.  Serving's plan takes context-parallel prefill instead, exactly
  where the flag is on, the family is the transformer and the heads do
  not split.
* The partial leaves under the layout: in the transformer, exactly the
  leaves that do not split over ``"model"``; in hymba, the
  context-parallel attention branch's, where its heads do not split.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro import configs as RCFG
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import Pipeline as RPipeline
from repro.models import get_family as ref_family
from repro_torch import configs as TCFG
from repro_torch import tree
from repro_torch.models.registry import get_family
from repro_torch.runtime import sharding as S
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import Scheduler


class _RankMesh:
    """A ``DeviceMesh`` stand-in for rank 0 of a ``(1, mp)`` mesh: what
    ``tensor_parallel`` and ``shard_params`` read, no process group."""
    mesh_dim_names = ("data", "model")

    def __init__(self, mp):
        self.mp = mp

    def size(self, i=None):
        return (1, self.mp)[i]

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return 0


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "hymba-1.5b"])
def test_reference_step_is_bit_equal_with_the_flag(arch):
    """The reference's jitted loss and gradients of a reduced f32 config
    on one device (its transformer's ``_sp_constraint`` and its
    attention's ``_attn_context_parallel``; hymba's attention branch)
    with the flag on, as published, and off."""
    on = RCFG.get_config(arch).reduced(compute_dtype="float32")
    assert on.seq_shard_activations
    off = dataclasses.replace(on, seq_shard_activations=False)
    fam = ref_family(on)
    params = fam.init_params(jax.random.PRNGKey(0), on)
    batch = RPipeline(RDataConfig(seed=5), on, global_batch=2, seq_len=32).batch_at(0)

    def run(cfg):
        loss, grads = jax.jit(jax.value_and_grad(lambda p: fam.train_loss(p, batch, cfg)))(
            params)
        return np.asarray(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]

    (l_on, g_on), (l_off, g_off) = run(on), run(off)
    assert l_on.tobytes() == l_off.tobytes()
    assert len(g_on) == len(g_off)
    for a, b in zip(g_on, g_off):
        assert a.tobytes() == b.tobytes()


def _flagged(arch):
    cfg = TCFG.get_config(arch).reduced(compute_dtype="float32")
    assert cfg.seq_shard_activations            # the published config sets it
    return cfg, get_family(cfg).init_params(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("paged", [False, True])
def test_serving_plans_keep_the_head_layout(paged):
    """``Engine(mesh=)`` (linear and paged) and a scheduler over it: the
    plan of phi3, whose flag is on, has ``seq`` false; the training
    step's plan on the same mesh has it true."""
    cfg, params = _flagged("phi3-medium-14b")
    mesh = _RankMesh(2)
    eng = Engine(cfg, params, max_len=64, device="cpu", mesh=mesh, paged=paged,
                 block_size=8 if paged else 16, n_blocks=32 if paged else 0)
    assert eng.tp is not None and not eng.tp.seq
    sched = Scheduler(eng, n_slots=2, chunk_size=4, chunked_prefill=paged)
    assert not sched.engine.tp.seq
    assert S.tensor_parallel(cfg, mesh, seq=cfg.seq_shard_activations).seq


@pytest.mark.parametrize("mp", [1, 2, 4])
@pytest.mark.parametrize("flag", [True, False])
@pytest.mark.parametrize("arch", ["phi3-medium-14b", "minicpm3-4b", "granite-34b",
                                  "internvl2-1b", "hymba-1.5b", "rwkv6-7b", "whisper-tiny"])
def test_serving_takes_context_parallel_prefill_where_heads_do_not_split(arch, flag, mp):
    """The engine's plan (``serve=True``) takes context-parallel prefill
    exactly where the config's flag is set, the family is the
    transformer, ``"model"`` > 1 and the attention's heads do not split
    (at 4: the reduced phi3's and internvl2-1b's 4 heads over 2 KV heads,
    minicpm3's MLA with 6 heads); the training plan never does, and its
    ``seq`` is unchanged."""
    over = {"n_heads": 6} if arch == "minicpm3-4b" else {}
    cfg = dataclasses.replace(TCFG.get_config(arch).reduced(compute_dtype="float32", **over),
                              seq_shard_activations=flag)
    tp = S.tensor_parallel(cfg, _RankMesh(mp), serve=True)
    if mp == 1:
        assert tp is None
        return
    want = flag and cfg.family == "transformer" and not S._split_groups(cfg, mp)["attn"]
    assert tp.cp is want and not tp.seq
    # at 4 the heads of phi3, minicpm3 (6) and internvl2-1b do not split;
    # granite-34b's 4 query heads over its one KV head do
    assert want is (flag and mp == 4 and arch in ("phi3-medium-14b", "minicpm3-4b",
                                                   "internvl2-1b"))
    train = S.tensor_parallel(cfg, _RankMesh(mp), seq=flag)
    assert not train.cp and train.seq is (flag and cfg.family in S.SEQ_FAMILIES)


@pytest.mark.parametrize("arch,seq", [("phi3-medium-14b", True), ("hymba-1.5b", True),
                                      ("rwkv6-7b", False), ("whisper-tiny", False)])
def test_training_plan_takes_the_layout_where_the_family_has_one(arch, seq):
    """With the flag forced on, the plan's ``seq`` is set in the
    transformer family and hymba (``sharding.SEQ_FAMILIES``), never in
    rwkv6 and whisper, whose reference reads no such layout; at a
    ``"model"`` axis of 1 there is no plan at all."""
    cfg = dataclasses.replace(TCFG.get_config(arch).reduced(compute_dtype="float32"),
                              seq_shard_activations=True)
    assert S.tensor_parallel(cfg, _RankMesh(2), seq=True).seq is seq
    assert S.tensor_parallel(cfg, _RankMesh(1), seq=True) is None


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("arch", ["phi3-medium-14b", "minicpm3-4b", "granite-34b",
                                  "granite-moe-3b-a800m", "gemma-7b", "internvl2-1b"])
def test_transformer_partial_leaves_are_the_unsplit_ones(arch, mp):
    """Under the transformer's sequence layout each rank holds a part of
    the gradient of every leaf it holds whole (``split_leaves`` false),
    and of no leaf it holds a slice of; the head layout's partial leaves
    (the router alone) are among them."""
    cfg, params = _flagged(arch)
    mesh = _RankMesh(mp)
    local = S.shard_params(params, mesh, cfg)
    seq = S.partial_grad_leaves(local, cfg, S.tensor_parallel(cfg, mesh, seq=True))
    split = S.split_leaves(local, cfg, mesh)
    assert seq == [not s for s in split]
    head = S.partial_grad_leaves(local, cfg, S.tensor_parallel(cfg, mesh))
    assert all(s for s, h in zip(seq, head) if h)
    assert any(seq) and not all(seq)


@pytest.mark.parametrize("mp,want", [(2, []), (4, ["attn_norm/scale", "wk/w", "wq/w",
                                                    "wv/w"])])
def test_hymba_partial_leaves_under_the_layout(mp, want):
    """Hymba at ``"model"`` 4 (its 2 KV heads do not split there): the
    context-parallel branch's ``wq``, ``wk``, ``wv`` and ``attn_norm``
    join the partial leaves; at 2 its heads split, and the layout leaves
    the head layout's partial leaves as they are."""
    cfg, params = _flagged("hymba-1.5b")
    mesh = _RankMesh(mp)
    local = S.shard_params(params, mesh, cfg)
    named = [p for p, _ in tree.leaves_with_paths(local)]
    seq = S.partial_grad_leaves(local, cfg, S.tensor_parallel(cfg, mesh, seq=True))
    head = S.partial_grad_leaves(local, cfg, S.tensor_parallel(cfg, mesh))
    added = sorted({p.split("/", 2)[2] for p, s, h in zip(named, seq, head) if s != h})
    assert added == want
    assert all(s == h for s, h in zip(seq, head) if h)
