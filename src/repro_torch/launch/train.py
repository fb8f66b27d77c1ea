"""Training launcher on one device or data parallel over ranks.

The port of ``repro/launch/train.py``: config -> data pipeline -> train
step -> supervised loop with async checkpoints, auto-resume and the
straggler watchdog.  It takes the reference's command line and defaults
and adds the port's own ``--device`` (default ``cuda``) and
``--n-layers`` (cut depth; every width stays the architecture's).
``--arch`` takes every architecture id; ``--reduced`` shrinks it to a
CPU-sized f32 model.  Parameters are f32 master weights drawn in f32
(seed 0) and cast to the compute dtype at use; ``--posit-moments``
keeps Adam's first moment as posit16 patterns on the codec kernels.
By default one device holds the whole model.  ``--rank-devices`` (e.g.
``cuda:0,cuda:1`` or ``cpu,cpu``) spawns a rank a device
(``launch/mesh.spawn``) over ``make_host_mesh()``, an ``(n, 1)``
mesh: data parallel, as the reference trains over its host mesh of
every device.  Each rank draws the same weights and the same global
batches from the seeds, runs its rows and all-reduces the gradients;
rank 0 prints and writes the checkpoints.  Model parallelism (every
family) and the pod-compressed step have no flag, as in the reference:
they are reached through ``runtime.train_loop.make_train_step(mesh=)``.
So is the sequence layout (Megatron-SP residuals and context-parallel
attention), which that step takes under a ``"model"`` axis from the
config's ``seq_shard_activations``; this launcher turns the flag off, as
the reference's does.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \\
      --reduced --steps 300 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \\
      --n-layers 8 --batch 8 --seq 512 --steps 8 --posit-moments --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \\
      --reduced --steps 20 --batch 8 --seq 64 --rank-devices cpu,cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import os
import sys
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.device import resolve_device
from repro_torch.models import get_family
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop
from repro_torch.runtime.fault import StragglerWatchdog, TrainSupervisor


@dataclasses.dataclass
class TrainResult:
    losses: list            # each executed step's loss (replays included)
    grad_norms: list
    step_walls: list        # seconds a step: the batch, the step, the loss read
    state: tuple            # the final (params, opt_state); None over ranks
    executed: int
    cfg: object
    ckpt: Checkpointer      # None over ranks
    supervisor: TrainSupervisor
    watchdog: StragglerWatchdog
    ranks: list = None      # over ranks: each rank's losses, grad norms, walls


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=configs.ARCH_IDS, default="gemma-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut depth to this many layers (0 = the "
                         "architecture's); widths are never cut")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--data", choices=["synthetic", "bytes"], default="synthetic")
    ap.add_argument("--corpus", default=None)
    ap.add_argument("--posit-moments", action="store_true",
                    help="store Adam first moments in posit16")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank-devices", default=None,
                    help="comma-separated devices, a data-parallel rank each "
                         "(e.g. cuda:0,cuda:1 or cpu,cpu)")
    return ap


def model_config(args):
    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(compute_dtype="float32")
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    return dataclasses.replace(cfg, fsdp=False, seq_shard_activations=False)


def main(argv=None) -> TrainResult:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.rank_devices:
        return _train_ranks(args, argv)
    return _train(args, resolve_device(args.device))


def _train_ranks(args, argv) -> TrainResult:
    """``--rank-devices``: a rank a device, joined; rank 0's numbers."""
    from repro_torch.launch import mesh as M

    devices = args.rank_devices.split(",")
    cpu = all(torch.device(d).type == "cpu" for d in devices)
    ranks = M.spawn(_rank_main, devices, (argv, devices), timeout=None,
                    threads=max(1, torch.get_num_threads() // len(devices)) if cpu else 0)
    r0 = ranks[0]
    return TrainResult(r0["losses"], r0["grad_norms"], r0["step_walls"], None,
                       r0["executed"], model_config(args), None, None, None, ranks)


def _rank_main(argv, devices) -> dict:
    """One data-parallel rank: its device, the ``(n, 1)`` host mesh, the
    loop; only rank 0 prints."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    args = build_parser().parse_args(argv)
    dev = resolve_device(devices[dist.get_rank()])
    mesh = make_host_mesh(1, dev.type)
    quiet = contextlib.redirect_stdout(io.StringIO()) if dist.get_rank() \
        else contextlib.nullcontext()
    with quiet:
        res = _train(args, dev, mesh)
    return {"losses": res.losses, "grad_norms": res.grad_norms,
            "step_walls": res.step_walls, "executed": res.executed}


def _train(args, dev, mesh=None) -> TrainResult:
    cfg = model_config(args)
    fam = get_family(cfg)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, posit_moments=args.posit_moments)
    pipe = Pipeline(DataConfig(source=args.data, path=args.corpus), cfg,
                    args.batch, args.seq, device=dev)

    params = fam.init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    opt_state = adamw.init(params, opt_cfg)
    step_fn = train_loop.make_train_step(cfg, opt_cfg, total_steps=args.steps, mesh=mesh)

    ckpt = Checkpointer(args.ckpt_dir, keep=2, mesh=mesh)
    watchdog = StragglerWatchdog()
    supervisor = TrainSupervisor(ckpt, save_every=args.save_every,
                                 watchdog=watchdog)

    t_start = time.time()
    losses, gnorms, walls = [], [], []

    def one_step(state, step):
        t0 = time.perf_counter()
        params, opt_state = state
        batch = pipe.batch_at(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        gnorms.append(gnorm)
        if step % args.log_every == 0:
            dt = time.time() - t_start
            print(f"step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"({dt:.1f}s)", flush=True)
        return params, opt_state

    state, executed = supervisor.run(
        state=(params, opt_state), step_fn=one_step, total_steps=args.steps)
    if losses:
        print(f"done: {executed} steps, final loss {losses[-1]:.4f}, "
              f"first loss {losses[0]:.4f}, "
              f"stragglers flagged {watchdog.stragglers}")
    else:
        print(f"done: nothing to run, the checkpoint is at step {args.steps}")
    return TrainResult(losses, gnorms, walls, state, executed, cfg, ckpt,
                       supervisor, watchdog)


if __name__ == "__main__":
    main()
