"""Elastic scaling demo: train, 'lose' half the cluster, resume.

The port of the reference's ``examples/elastic_restart.py``: a small LM
(gemma-7b reduced, f32) trains 20 steps data parallel on two ranks (a
``(data 2, model 1)`` mesh, ``launch.mesh.spawn``: gloo, on the CPU or
two ranks sharing one card), checkpoints, then restores the same
checkpoint on one device (no mesh) and continues 10 steps -- the loss
continues from where it left off.  This is the mesh-agnostic checkpoint
path that lets a job resume on fewer devices after losing some.

  PYTHONPATH=src python -m repro_torch.examples.elastic_restart [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile

import torch

from repro_torch import configs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.device import resolve_device
from repro_torch.models import get_family
from repro_torch.optim import adamw
from repro_torch.runtime import sharding, train_loop

RANK_STEPS, RESUME_STEPS = 20, 10
N_RANKS = 2


def setup(dev):
    """``(cfg, opt_cfg, pipeline)``: the reference's model, optimizer and
    data (seed 17, 8 x 64); whole parameters on every rank, as the
    reference places them (``param_shardings`` without FSDP)."""
    cfg = dataclasses.replace(
        configs.get_config("gemma-7b").reduced(compute_dtype="float32"),
        fsdp=False, seq_shard_activations=False)
    return (cfg, adamw.AdamWConfig(lr=1e-3),
            Pipeline(DataConfig(seed=17), cfg, 8, 64, device=dev))


def _fresh_state(cfg, opt_cfg, dev):
    params = get_family(cfg).init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    return params, adamw.init(params, opt_cfg)


def train_ranks(ckpt_dir: str, devices) -> list:
    """One rank of phase 1 (called on every rank of a two-rank process
    group): ``RANK_STEPS`` steps on a ``(data 2, model 1)`` mesh, then
    the checkpoint (whole leaves, written by rank 0).  Returns this
    rank's losses."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    dev = torch.device(devices[dist.get_rank()])
    mesh = make_mesh((N_RANKS, 1), ("data", "model"), dev.type)
    cfg, opt_cfg, pipe = setup(dev)
    params, opt = _fresh_state(cfg, opt_cfg, dev)
    params = sharding.shard_params(params, mesh, cfg)
    step_fn = train_loop.make_train_step(cfg, opt_cfg, mesh=mesh)
    losses = []
    for i in range(RANK_STEPS):
        params, opt, m = step_fn(params, opt, pipe.batch_at(i), i)
        losses.append(float(m["loss"]))
    state = {"params": params, "opt": opt}
    sh = {k: sharding.param_shardings(state[k], mesh, cfg=cfg) for k in state}
    Checkpointer(ckpt_dir, keep=1, mesh=mesh).save(RANK_STEPS, state, shardings=sh)
    return losses


def resume(ckpt_dir: str, device="cuda") -> dict:
    """Phase 2: 'a device died' -- restore the two ranks' checkpoint on
    one device and train ``RESUME_STEPS`` more steps."""
    dev = resolve_device(device)
    cfg, opt_cfg, pipe = setup(dev)
    params, opt = _fresh_state(cfg, opt_cfg, dev)
    state, step0 = Checkpointer(ckpt_dir, keep=1).restore(
        RANK_STEPS, {"params": params, "opt": opt})
    params, opt = state["params"], state["opt"]
    step_fn = train_loop.make_train_step(cfg, opt_cfg)
    resumed = []
    for i in range(step0, step0 + RESUME_STEPS):
        params, opt, m = step_fn(params, opt, pipe.batch_at(i), i)
        resumed.append(float(m["loss"]))
    return dict(step0=step0, resumed=resumed)


def run(device="cuda") -> dict:
    from repro_torch.launch import mesh as M

    dev = resolve_device(device)
    devices = [f"cuda:{dev.index or 0}" if dev.type == "cuda" else "cpu"] * N_RANKS
    with tempfile.TemporaryDirectory(prefix="repro_elastic_") as ckpt_dir:
        ranks = M.spawn(train_ranks, devices, (ckpt_dir, devices), timeout=600,
                        threads=1 if dev.type == "cpu" else 0)
        res = resume(ckpt_dir, dev)
    return dict(losses=ranks[0], **res)


def check(res: dict) -> None:
    assert res["resumed"][0] < res["losses"][0], "resume lost training progress"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    losses, resumed = res["losses"], res["resumed"]
    print(f"phase 1 ({N_RANKS} ranks): loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"checkpoint at step {RANK_STEPS}")
    print(f"phase 2 (1 device, restored step {res['step0']}): "
          f"loss {resumed[0]:.3f} -> {resumed[-1]:.3f}")
    check(res)
    print("OK: elastic re-mesh resume preserved progress")


if __name__ == "__main__":
    main()
