"""Rank meshes and the rank launcher of serving and training across ranks.

The port of ``repro/launch/mesh.py``'s ``make_host_mesh``: a
``("data", "model")`` ``DeviceMesh`` over the process group's world;
and :func:`make_mesh`, the counterpart of ``jax.make_mesh(shape,
names)`` as the reference's tests call it (``("pod", "data",
"model")`` or ``("data", "model")``).
Where the reference's mesh spans the devices of one process, each rank
here is a process: :func:`spawn` starts them (``torch.multiprocessing``,
the spawn method), gives each its device and joins them to one process
group, and returns what each rank's function returned.

Backends: NCCL when every rank has a card of its own, gloo otherwise (the
CPU, or ranks that share a card: NCCL refuses two ranks on one device).
Rendezvous goes through a ``FileStore`` in a fresh temporary directory,
so concurrent launches never collide on a port.  A rank that raises, or
a launch that outlives its ``timeout`` where one is given, ends every
rank and raises here with the failing rank's traceback; a collective
left blocked longer than ``COLLECTIVE_TIMEOUT`` fails its rank, so no
rank waits forever on one that hangs.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
import warnings

import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


def make_host_mesh(model_parallel: int = 1, device_type: str = "cpu"):
    """A ``("data", "model")`` mesh over the process group's world.

    ``model_parallel`` that does not divide the world size cannot factor
    an ``(n // mp, mp)`` mesh; it is rounded down to the largest divisor
    of ``n``, with a warning.  ``device_type`` is the ranks' device type
    (each rank's device is already set by :func:`spawn`)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    mp = max(1, min(int(model_parallel), n))
    while n % mp:
        mp -= 1
    if mp != model_parallel:
        warnings.warn(
            f"model_parallel={model_parallel} does not factor the {n}-rank "
            f"world; rounding down to model_parallel={mp}", stacklevel=2)
    return init_device_mesh(device_type, (n // mp, mp), mesh_dim_names=("data", "model"))


def make_mesh(shape, names, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over the process
    group's world, ranks laid out row-major (the last axis fastest, as
    ``jax.make_mesh`` lays out devices).  ``device_type`` is the ranks'
    device type."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = tuple(int(n) for n in shape), tuple(names)
    n = 1
    for k in shape:
        n *= k
    if n != dist.get_world_size() or len(shape) != len(names):
        raise ValueError(f"a mesh of shape {shape} over axes {names} needs "
                         f"{n} ranks; the world has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def fake_mesh(shape, names, device_type: str = "cuda"):
    """A mesh of ``shape`` over axes ``names`` at its full world size in
    this one process, as rank 0 of a fake process group: the dry run's
    ``16x16`` (``("data", "model")``, 256 ranks) or ``2x16x16``
    (``("pod", "data", "model")``, 512).  The collectives then run on
    fake tensors and move nothing.  Uses ``FakeStore`` and the ``"fake"``
    backend of ``torch.testing._internal.distributed.fake_pg``, a private
    module of torch (present in 2.11 and 2.13); it joins the default
    process group, so a process holds one fake mesh at a time
    (``torch.distributed.destroy_process_group`` leaves it)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = 1
    for k in shape:
        n *= int(k)
    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a process group is already initialised")
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    return make_mesh(shape, names, device_type)


def backend_for(devices) -> str:
    """``"nccl"`` when every rank has a card of its own, else ``"gloo"``."""
    devs = [torch.device(d) for d in devices]
    cards = [d.index or 0 for d in devs if d.type == "cuda"]
    return "nccl" if len(cards) == len(devs) and len(set(cards)) == len(cards) else "gloo"


def default_devices(n: int, device="cuda") -> list:
    """One card a rank (``cuda:0 .. cuda:n-1``), or ``n`` CPU ranks."""
    if torch.device(device).type == "cpu":
        return ["cpu"] * n
    return [f"cuda:{i}" for i in range(n)]


def _rank_main(rank, fn, args, devices, store, threads, results):
    try:
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend_for(devices), init_method=f"file://{store}", rank=rank,
            world_size=len(devices), timeout=COLLECTIVE_TIMEOUT)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                     # reported to the parent
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, devices, args=(), *, timeout: float | None = 600.0, threads: int = 0) -> list:
    """Run ``fn(*args)`` on one process a device of ``devices`` (e.g.
    ``["cpu", "cpu"]``, ``["cuda:0", "cuda:1"]`` or ``["cuda:0",
    "cuda:0"]``), joined in one process group; returns each rank's
    result, rank 0 first.  ``fn`` and ``args`` must pickle (a module-level
    function), and so must its result: return host data (numpy arrays,
    Python values).  ``fn`` reads its rank from ``torch.distributed``;
    the rank's device is set.  ``threads`` > 0 sets each rank's torch
    threads.  Raises ``RuntimeError`` when a rank fails or, unless
    ``timeout`` is ``None``, when ``timeout`` seconds pass, after ending
    every rank."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, fn, tuple(args), list(devices), os.path.join(tmp, "store"),
                               threads, results))
             for r in range(len(devices))]
    out, error = {}, None
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < len(procs) and error is None:
            try:
                rank, ok, val = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in out]
                if dead and results.empty():
                    error = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                elif deadline is not None and time.monotonic() > deadline:
                    error = f"ranks still running after {timeout:.0f} s"
                continue
            if ok:
                out[rank] = val
            else:
                error = f"rank {rank} failed:\n{val}"
        if error is not None:                 # the other ranks' failures too
            time.sleep(1.0)
            while not results.empty():
                rank, ok, val = results.get()
                if not ok:
                    error += f"\nrank {rank} failed:\n{val}"
    finally:
        for p in procs:
            if error is not None and p.is_alive():
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if error is not None:
        raise RuntimeError(f"tensor-parallel ranks: {error}")
    return [out[r] for r in range(len(procs))]
