"""The port's training infrastructure against the reference.

``Pipeline`` batches bit for bit (synthetic and bytes tokens, whisper's
frames, internvl's visual prefix); ``compress_with_feedback`` patterns
and residuals bit for bit (posit16 and posit8); the checkpoint's posit16
payload: the patterns on disk bit for bit, and what each package
restores from the other's file; ``TrainSupervisor`` and
``StragglerWatchdog`` event lists equal on the same fail hook and step
timings.  Then port-side mirrors of ``tests/test_data.py``,
``tests/test_fault.py`` and ``tests/test_checkpoint.py`` (its re-mesh
test across ranks is in ``tests/test_torch_train_elastic.py``; here
``restore(shardings=)`` with whole placements on one device).
"""
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as RCFG
from repro.checkpoint.checkpointer import Checkpointer as RCheckpointer
from repro.compress import gradient as ref_gc
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import Pipeline as RPipeline
from repro.models.config import ModelConfig as RModelConfig
from repro.runtime import fault as ref_fault
from repro.runtime.fault import StragglerWatchdog as RWatchdog
from repro_torch import configs as TCFG
from repro_torch import tree as TT
from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.compress import gradient as gc
from repro_torch.core.types import signed_view
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import fault
from repro_torch.runtime.fault import StragglerWatchdog, TrainSupervisor


def _np(t):
    if t.dtype in (torch.uint16, torch.uint8):
        return signed_view(t).numpy().view(np.uint16 if t.dtype == torch.uint16
                                           else np.uint8)
    return t.numpy()


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma-7b", "whisper-tiny", "internvl2-1b"])
def test_pipeline_batches_equal_reference(arch):
    rc = RCFG.get_config(arch).reduced(compute_dtype="float32")
    tc = TCFG.get_config(arch).reduced(compute_dtype="float32")
    for seed, step in ((1234, 0), (7, 3), (7, 1000)):
        want = RPipeline(RDataConfig(seed=seed), rc, 4, 48).batch_at(step)
        got = Pipeline(DataConfig(seed=seed), tc, 4, 48, device="cpu").batch_at(step)
        assert set(got) == set(want)
        for k in want:
            w = np.array(want[k])
            assert got[k].dtype == torch.from_numpy(w).dtype
            np.testing.assert_array_equal(got[k].numpy(), w)
    expect = {"whisper-tiny": {"tokens", "frames"}, "internvl2-1b": {"tokens", "visual"}}
    assert set(got) == expect.get(arch, {"tokens"})


def test_pipeline_bytes_equal_reference(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_bytes(bytes(range(256)) * 7 + b"the quick brown fox " * 40)
    for vocab in (256, 97):
        want = RPipeline(RDataConfig(source="bytes", path=str(path), seed=3),
                         RModelConfig(vocab=vocab), 3, 20).batch_at(5)
        got = Pipeline(DataConfig(source="bytes", path=str(path), seed=3),
                       ModelConfig(vocab=vocab), 3, 20, device="cpu").batch_at(5)
        np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))


def _pipe(**kw):
    return Pipeline(DataConfig(**kw), ModelConfig(vocab=512), global_batch=4, seq_len=32,
                    device="cpu")


def test_batches_deterministic_and_index_addressable():
    np.testing.assert_array_equal(_pipe(seed=7).batch_at(123)["tokens"].numpy(),
                                  _pipe(seed=7).batch_at(123)["tokens"].numpy())


def test_different_steps_different_batches():
    p = _pipe(seed=7)
    assert (p.batch_at(0)["tokens"] != p.batch_at(1)["tokens"]).any()


def test_resume_equals_uninterrupted_run():
    p = _pipe(seed=3)
    full = [p.batch_at(i)["tokens"] for i in range(10)]
    for i in range(5, 10):
        assert torch.equal(full[i], _pipe(seed=3).batch_at(i)["tokens"])
    it = iter(_pipe(seed=3))
    assert torch.equal(next(it)["tokens"], full[0])


def test_tokens_in_vocab_range():
    t = _pipe(seed=11).batch_at(2)["tokens"]
    assert int(t.min()) >= 0 and int(t.max()) < 512
    assert t.dtype == torch.int32


def test_bytes_corpus_mode(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_text("the quick brown fox jumps over the lazy dog " * 50)
    p = Pipeline(DataConfig(source="bytes", path=str(path)), ModelConfig(vocab=256), 2, 16,
                 device="cpu")
    t = p.batch_at(0)["tokens"]
    assert tuple(t.shape) == (2, 16) and int(t.max()) < 256
    (tmp_path / "tiny.txt").write_text("abc")
    with pytest.raises(ValueError, match="corpus too small"):
        Pipeline(DataConfig(source="bytes", path=str(tmp_path / "tiny.txt")),
                 ModelConfig(vocab=256), 2, 16, device="cpu")


# ---------------------------------------------------------------------------
# Error-feedback compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["posit16", "posit8"])
def test_compress_with_feedback_equals_reference(name):
    """Two rounds (the second carries the first's residual), on a tree
    with layer lists on the port's side and stacked leaves on the
    reference's."""
    rng = np.random.default_rng(2)
    stacked = {"layers": {"w": rng.standard_normal((2, 6, 5)).astype(np.float32)},
               "b": (1e-3 * rng.standard_normal(9)).astype(np.float32)}
    port = {"layers": [{"w": torch.from_numpy(stacked["layers"]["w"][i].copy())}
                       for i in range(2)], "b": torch.from_numpy(stacked["b"].copy())}
    r_err = ref_gc.init_error_state(stacked)
    t_err = gc.init_error_state(port)
    assert all(float(e.abs().sum()) == 0 and e.dtype == torch.float32
               for e in (t_err["b"], t_err["layers"][0]["w"]))
    for scale in (1.0, 7.0):
        r_q, r_err = jax.jit(lambda g, e: ref_gc.compress_with_feedback(g, e, name))(
            jax.tree.map(lambda a: jnp.asarray(a * scale), stacked), r_err)
        t_q, t_err = gc.compress_with_feedback(
            {"layers": [{"w": l["w"] * scale} for l in port["layers"]],
             "b": port["b"] * scale}, t_err, name)
        for i in range(2):
            np.testing.assert_array_equal(_np(t_q["layers"][i]["w"]),
                                          np.asarray(r_q["layers"]["w"])[i])
            np.testing.assert_array_equal(t_err["layers"][i]["w"].numpy(),
                                          np.asarray(r_err["layers"]["w"])[i])
        np.testing.assert_array_equal(_np(t_q["b"]), np.asarray(r_q["b"]))
        np.testing.assert_array_equal(t_err["b"].numpy(), np.asarray(r_err["b"]))


# ---------------------------------------------------------------------------
# Checkpointer
# ---------------------------------------------------------------------------

def _ref_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"layers": {"w": jnp.asarray(rng.standard_normal((8, 16)), jnp.float32),
                       "b": jnp.asarray(rng.standard_normal(16), jnp.float32)},
            "count": jnp.asarray(7, jnp.int32)}


def _tree(seed=0):
    """The port's copy of ``_ref_tree`` (the same leaf order: ``jax.tree``
    sorts keys, this tree is written in sorted order)."""
    r = _ref_tree(seed)
    return {"count": torch.tensor(7, dtype=torch.int32),
            "layers": {"b": torch.from_numpy(np.array(r["layers"]["b"])),
                       "w": torch.from_numpy(np.array(r["layers"]["w"]))}}


def test_posit_payload_equals_reference(tmp_path):
    """The posit16 patterns on disk, the meta entries, and each package
    restoring the other's file."""
    ref = RCheckpointer(str(tmp_path / "ref"), keep=1, posit_payload=True)
    port = Checkpointer(str(tmp_path / "port"), keep=1, posit_payload=True)
    ref.save(3, _ref_tree(3), blocking=True)
    port.save(3, _tree(3), blocking=True)
    r_npz = np.load(tmp_path / "ref" / "step_00000003" / "arrays.npz")
    t_npz = np.load(tmp_path / "port" / "step_00000003" / "arrays.npz")
    assert sorted(r_npz.files) == sorted(t_npz.files) == ["a0", "a1", "a2"]
    for k in r_npz.files:
        assert r_npz[k].dtype == t_npz[k].dtype
        np.testing.assert_array_equal(t_npz[k], r_npz[k])
    metas = [json.load(open(tmp_path / d / "step_00000003" / "checkpoint_complete.json"))
             for d in ("ref", "port")]
    for a, b in zip(*(m["leaves"] for m in metas)):
        assert (a["dtype"], a["shape"], a["codec"]) == (b["dtype"], b["shape"], b["codec"])
    assert [e["codec"] for e in metas[1]["leaves"]] == ["raw", "posit16", "posit16"]
    # each package restores either file to the same values
    port_restores = [Checkpointer(str(tmp_path / d)).restore(3, _tree())[0]
                     for d in ("ref", "port")]
    ref_restores = [RCheckpointer(str(tmp_path / d)).restore(3, _ref_tree())[0]
                    for d in ("ref", "port")]
    for got in port_restores:
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref_restores[0])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(jax.tree.leaves(ref_restores[1]), jax.tree.leaves(ref_restores[0])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    w0 = _tree(3)["layers"]["w"]
    err = float((port_restores[1]["layers"]["w"] - w0).abs().max())
    assert 0 < err <= 3e-3 * float(w0.abs().max())


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    t = _tree()
    t["bf16"] = torch.randn(5, 3).to(torch.bfloat16)
    t["u16"] = torch.tensor([0, 1, 0x8000, 0xFFFF], dtype=torch.int32).to(torch.uint16)
    ck.save(10, t, blocking=True)
    assert ck.latest_step() == 10
    restored, step = ck.restore(10, t)
    assert step == 10
    for a, b in zip(jax.tree.leaves(t), jax.tree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(signed_view(a), signed_view(b))


def test_async_save_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s))
    ck.wait()
    ck._gc()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [3, 4]
    assert ck.last_save["bytes"] == 4 + 16 * 4 + 128 * 4 and "write_s" in ck.last_save


@pytest.mark.parametrize("posit_payload", [False, True], ids=["raw", "posit-payload"])
def test_async_save_holds_the_values_at_save_time(tmp_path, monkeypatch, posit_payload):
    """The optimizer writes the live tensors in place while the worker
    thread writes the file: the checkpoint holds the values as they were
    when ``save`` was called, as a blocking save of a copy does."""
    import threading

    def tree():
        t = _tree(4)
        t["bf16"] = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)).to(
            torch.bfloat16)
        t["u16"] = torch.tensor([0, 1, 0x8000, 0xFFFF], dtype=torch.int32).to(torch.uint16)
        return t

    live = tree()
    snapshot = TT.tree_map(torch.clone, live)      # the port's walk order
    go, savez = threading.Event(), ckpt_mod.np.savez

    def held(*a, **kw):
        assert go.wait(30)
        savez(*a, **kw)

    monkeypatch.setattr(ckpt_mod.np, "savez", held)
    ck = Checkpointer(str(tmp_path / "async"), keep=1, posit_payload=posit_payload)
    ck.save(1, live)
    for x in jax.tree.leaves(live):                 # the next step, in place
        signed_view(x).add_(1)
    go.set()
    ck.wait()
    want = Checkpointer(str(tmp_path / "copy"), keep=1, posit_payload=posit_payload)
    want.save(1, snapshot, blocking=True)
    got = ck.restore(1, tree())[0]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want.restore(1, tree())[0])):
        assert a.dtype == b.dtype and torch.equal(signed_view(a), signed_view(b))


def test_interrupted_save_never_corrupts(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(5, _tree(5), blocking=True)
    os.makedirs(tmp_path / "tmp.6")
    with open(tmp_path / "tmp.6" / "arrays.npz", "w") as f:
        f.write("garbage")
    assert ck.latest_step() == 5
    restored, _ = ck.restore(5, _tree())
    assert torch.isfinite(restored["layers"]["w"]).all()


def test_posit_payload_roundtrip_accuracy(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=1, posit_payload=True)
    t = _tree(3)
    ck.save(1, t, blocking=True)
    restored, _ = ck.restore(1, t)
    np.testing.assert_allclose(restored["layers"]["w"].numpy(), t["layers"]["w"].numpy(),
                               rtol=3e-3, atol=1e-4)
    assert int(restored["count"]) == 7 and restored["count"].dtype == torch.int32


def test_save_refuses_when_the_disk_is_short(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path), keep=1)
    real = ckpt_mod.shutil.disk_usage
    monkeypatch.setattr(ckpt_mod.shutil, "disk_usage",
                        lambda p: real(p)._replace(free=1000))
    with pytest.raises(OSError, match="only 1,000 are free"):
        ck.save(1, _tree())
    assert ck.latest_step() is None and not os.listdir(tmp_path)


def test_async_save_error_surfaces_at_wait(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path), keep=1)

    def boom(*a, **kw):
        raise IOError("disk gone")

    monkeypatch.setattr(ckpt_mod.np, "savez", boom)
    ck.save(1, _tree())
    with pytest.raises(IOError, match="disk gone"):
        ck.wait()


def test_restore_with_shardings_is_not_ported(tmp_path):
    """``restore(shardings=)`` narrows a leaf over one mesh axis a dim;
    a placement that splits one dim over several axes (the reference's
    ``("pod", "data")`` rows, say) is not ported and raises."""
    from repro_torch.runtime.sharding import NamedSharding

    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(2, _tree(), blocking=True)
    places = {"count": None, "layers": {"b": None,
                                        "w": NamedSharding(None, (("data", "model"), None))}}
    with pytest.raises(NotImplementedError, match="several axes"):
        ck.restore(2, _tree(), shardings=places)


def test_restore_with_whole_shardings_restores_whole_leaves(tmp_path):
    """Whole placements (``None`` leaves) restore every leaf whole, as
    the restore without them does."""
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(2, _tree(), blocking=True)
    whole, _ = ck.restore(2, _tree())
    placed, step = ck.restore(2, _tree(), shardings=TT.tree_map(lambda _: None, _tree()))
    assert step == 2
    for a, b in zip(TT.leaves(placed), TT.leaves(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# Supervisor and watchdog
# ---------------------------------------------------------------------------

def _fake_clock(monkeypatch, module, durations):
    """``module``'s ``time.monotonic`` reads that make step i last
    ``durations[i]`` (two reads a step: before and after)."""
    reads, now = [], 0.0
    for d in durations:
        reads += [now, now + d]
        now += d + 1.0
    it = iter(reads)
    monkeypatch.setattr(module, "time", types.SimpleNamespace(monotonic=lambda: next(it)))


@pytest.mark.parametrize("case", ["crash", "straggler_and_crash"])
def test_supervisor_events_equal_reference(tmp_path, monkeypatch, case):
    durations = [1.0] * 40
    if case == "straggler_and_crash":
        durations[6] = durations[15] = 9.0

    def hook():
        crashed = {"n": 0}

        def fail_hook(step):
            if step in (7, 12) and crashed["n"] < 2:
                crashed["n"] += 1
                raise RuntimeError(f"injected failure at {step}")
        return fail_hook

    results = []
    for pkg, (mod, Ck, zero) in {"ref": (ref_fault, RCheckpointer, jnp.asarray(0)),
                                 "port": (fault, Checkpointer, torch.tensor(0))}.items():
        Sup, Wd = mod.TrainSupervisor, mod.StragglerWatchdog
        _fake_clock(monkeypatch, mod, durations)
        sup = Sup(Ck(str(tmp_path / pkg), keep=2), save_every=5, max_restarts=3,
                  watchdog=Wd(threshold=2.0))
        state, executed = sup.run(state={"x": zero}, step_fn=lambda s, i: {"x": s["x"] + 1},
                                  total_steps=20, fail_hook=hook())
        results.append((sup.events, executed, int(state["x"]), sup.restarts,
                        sup.watchdog.stragglers))
    assert results[0] == results[1]
    assert results[1][2] == 20 and results[1][3] == 2
    assert (results[1][4] > 0) == (case == "straggler_and_crash")


def test_supervisor_recovers_from_failures(tmp_path):
    sup = TrainSupervisor(Checkpointer(str(tmp_path), keep=3), save_every=5, max_restarts=3)
    crashed = {"done": False}

    def fail_hook(step):
        if step == 12 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected node failure")

    state, executed = sup.run(state={"x": torch.tensor(0)},
                              step_fn=lambda s, i: {"x": s["x"] + 1}, total_steps=20,
                              fail_hook=fail_hook)
    assert int(state["x"]) == 20
    kinds = [e[0] for e in sup.events]
    assert "failure" in kinds and "resume" in kinds
    assert executed > 20


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    sup = TrainSupervisor(Checkpointer(str(tmp_path), keep=2), save_every=100,
                          max_restarts=2)

    def fail_hook(step):
        raise RuntimeError("always failing")

    with pytest.raises(RuntimeError, match="max_restarts"):
        sup.run(state={"x": torch.tensor(0)}, step_fn=lambda s, i: s, total_steps=10,
                fail_hook=fail_hook)


def test_supervisor_resumes_fresh_process(tmp_path):
    ck1 = Checkpointer(str(tmp_path), keep=2)
    sup1 = TrainSupervisor(ck1, save_every=5)

    def boom(step):
        if step == 8:
            raise KeyboardInterrupt()

    with pytest.raises(KeyboardInterrupt):
        sup1.run(state={"x": torch.tensor(0)}, step_fn=lambda s, i: {"x": s["x"] + 1},
                 total_steps=20, fail_hook=boom)
    ck1.wait()
    sup2 = TrainSupervisor(Checkpointer(str(tmp_path), keep=2), save_every=5)
    state, _ = sup2.run(state={"x": torch.tensor(0)},
                        step_fn=lambda s, i: {"x": s["x"] + 1}, total_steps=20)
    assert int(state["x"]) == 20
    assert ("resume", 5) in sup2.events


def test_straggler_watchdog():
    times = [1.0, 1.0, 1.0, 1.1, 0.9, 5.0, 1.0, 1.05, 4.0]
    wd, ref = StragglerWatchdog(threshold=2.0, warmup=3), RWatchdog(threshold=2.0, warmup=3)
    flags = [wd.observe(t) for t in times]
    assert flags == [ref.observe(t) for t in times]
    assert flags[5] is True and flags[8] is True
    assert sum(flags) == 2 and wd.stragglers == 2
