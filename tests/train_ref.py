"""The reference's side of the training-across-ranks tests (a helper
module, not a test file): its single-device jitted step and gradients on
a lane of ``tests/train_lanes.py``, the rank spawns beside them, and
the comparisons the test files share."""
import concurrent.futures
import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

import train_lanes as TL
from repro import configs as RCFG
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import Pipeline as RPipeline
from repro.models import get_family as ref_family
from repro.optim import adamw as ref_adamw
from repro.runtime import train_loop as ref_train_loop
from repro_torch.launch import mesh as M

SPAWN_TIMEOUT = 300


def ref_grads(rc, fam):
    """The gradient of the reference's step, as its ``_grads_of`` takes
    it: a scan over the microbatches, the sum scaled by ``1/accum``."""
    accum = max(1, rc.grad_accum)

    def grads(params, batch):
        micro = jax.tree.map(lambda x: x.reshape((accum, x.shape[0] // accum) + x.shape[1:]),
                             batch)

        def one(gsum, mbatch):
            g = jax.grad(lambda p: fam.train_loss(p, mbatch, rc))(params)
            return jax.tree.map(lambda a, b: a + b.astype(jnp.float32), gsum, g), None

        zeros = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        gsum, _ = jax.lax.scan(one, zeros, micro)
        return jax.tree.map(lambda g: g * (1.0 / accum), gsum)
    return grads


def ref_lane(lane, params):
    rc = dataclasses.replace(TL.config_of(RCFG, lane), seq_shard_activations=False)
    fam = ref_family(rc)
    batch = RPipeline(RDataConfig(seed=TL.SEED), rc, global_batch=TL.BATCH,
                      seq_len=TL.SEQ).batch_at(0)
    opt_cfg = ref_adamw.AdamWConfig(lr=TL.LR)
    p1, _, m1 = jax.jit(ref_train_loop.make_train_step(rc, opt_cfg))(
        params, ref_adamw.init(params, opt_cfg), batch, jnp.asarray(0))
    grads = jax.jit(ref_grads(rc, fam))(params, batch)
    return {"loss": float(m1["loss"]), "grad_norm": float(m1["grad_norm"]),
            "params": jax.tree.map(np.asarray, p1), "grads": jax.tree.map(np.asarray, grads)}


def init_params(lanes) -> tuple:
    """The reference's seeded parameters of each lane (drawn once a
    ``TL.ref_key``: an architecture and its changed fields), and the
    same as numpy trees by that key (what the ranks take)."""
    ref_params, np_params, by_key = {}, {}, {}
    for lane in lanes:
        key = TL.ref_key(lane)
        if key not in by_key:
            rc = TL.config_of(RCFG, lane)
            by_key[key] = ref_family(rc).init_params(jax.random.PRNGKey(0), rc)
            np_params[key] = jax.tree.map(np.asarray, by_key[key])
        ref_params[lane] = by_key[key]
    return ref_params, np_params


def run_lanes(by_world: dict) -> dict:
    """``{"ref": {lane: ...}, "got": {lane: rank 0's result}, "ranks":
    {lane: [every rank's result]}, "params": {key: the weights}}``: one spawn of ``TL.rank_lanes`` a
    world size, side by side, while the reference runs every lane's
    ``TL.ref_key`` once in this process (its single-device step does not
    depend on the lane's mesh or layout)."""
    lanes = [lane for group in by_world.values() for lane in group]
    ref_params, np_params = init_params(lanes)
    with concurrent.futures.ThreadPoolExecutor(len(by_world)) as pool:
        spawns = {n: pool.submit(M.spawn, TL.rank_lanes, ["cpu"] * n, (group, np_params),
                                 timeout=SPAWN_TIMEOUT, threads=1)
                  for n, group in by_world.items()}
        by_key = {}
        for lane in lanes:
            if TL.ref_key(lane) not in by_key:
                by_key[TL.ref_key(lane)] = ref_lane(lane, ref_params[lane])
        ref = {lane: by_key[TL.ref_key(lane)] for lane in lanes}
        got, every = {}, {}
        for n, fut in spawns.items():
            ranks = fut.result()
            assert all("params" not in r[lane] for r in ranks[1:] for lane in by_world[n])
            got.update(ranks[0])
            every.update({lane: [r[lane] for r in ranks] for lane in by_world[n]})
    return {"ref": ref, "got": got, "ranks": every, "params": np_params}


def walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def lookup(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def check_step(got, want):
    """The gate's bounds: the loss and every parameter after one step
    within 1e-4 of the reference's single-device step."""
    assert abs(got["loss"] - want["loss"]) < 1e-4, (got["loss"], want["loss"])
    assert abs(got["grad_loss"] - want["loss"]) < 1e-4
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
    n = 0
    for path, w in walk(want["params"]):
        g = lookup(got["params"], path)
        assert g.shape == w.shape, path
        assert float(np.abs(g - w).max()) < 1e-4, path
        n += 1
    assert n == len(list(walk(got["params"])))


def check_grads(got, want):
    """Every leaf's gradient within 1e-4 of its largest magnitude."""
    for path, w in walk(want):
        g = lookup(got, path)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= 1e-4 * scale, (path, float(np.abs(g - w).max()),
                                                             scale)


def check_fsdp(lane, ranks):
    """Every rank of an FSDP lane: each leaf that ``"data"`` splits is
    held as its ``1/n_data`` piece (the rank's parameter, ``m`` and ``v``
    bytes the whole bytes less ``1 - 1/n_data`` of the split leaves'),
    and the gradients' call made, for each microbatch the rank runs, one
    gather of each split leaf per use (the top-level leaves once, a
    layer's twice: its forward and its rematerialised recompute), one
    reduce-scatter of each, and no ``"data"`` all-reduce of their
    gradients (the other leaves' one each)."""
    from repro_torch import configs as TCFG

    cfg = TL.config_of(TCFG, lane)
    n_data = TL.LANES[lane]["mesh"][0]
    parts = cfg.grad_accum // n_data
    assert cfg.remat == "layer" and parts >= 1
    for r in ranks:
        lay = r["fsdp"]["leaves"]
        split = [(path, local) for path, d, _, local in lay if d is not None]
        assert split
        for path, d, piece, local in lay:
            assert piece == (local // n_data if d is not None else local), path
        whole = sum(local for *_, local in lay)
        params = sum(piece for _, _, piece, _ in lay)
        assert params == whole - sum(b for _, b in split) * (n_data - 1) // n_data
        assert r["fsdp"]["m"] == r["fsdp"]["v"] == params          # f32 moments
        top = sum(b for path, b in split if not path.startswith("layers/"))
        layer = sum(b for path, b in split if path.startswith("layers/"))
        n_top = sum(1 for path, _ in split if not path.startswith("layers/"))
        wire = r["wire"]
        assert wire["data/broadcast/fsdp_gather/float32"] == [     # a broadcast a rank
            n_data * parts * (n_top + 2 * (len(split) - n_top)), parts * (top + 2 * layer)]
        assert wire["data/all_reduce/fsdp_scatter/float32"] == [
            parts * len(split), parts * (top + layer)]
        assert wire.get("data/all_reduce/grad/float32", [0, 0])[0] == len(lay) - len(split)


def check_fsdp_twin(got):
    """An FSDP lane against its data-parallel twin (the same step on the
    same mesh with ``fsdp`` off): the same forward (the loss bit for
    bit), and the step within 1e-6, not bit-equal (the gradients' sums
    over the microbatches and the ranks, and the norm's, run in another
    order)."""
    twin = got["twin"]
    assert got["loss"] == twin["loss"]
    np.testing.assert_allclose(got["grad_norm"], twin["grad_norm"], rtol=1e-6)
    for path, w in walk(twin["params"]):
        assert float(np.abs(lookup(got["params"], path) - w).max()) <= 1e-6, path
