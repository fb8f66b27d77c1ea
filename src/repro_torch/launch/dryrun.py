"""The dry run: every (arch x shape x mesh) cell traced on fake tensors.

The port of ``repro/launch/dryrun.py``.  For each cell it joins a fake
process group at the production mesh's world size (``launch/mesh.
fake_mesh``: ``16x16``, 256 ranks, or ``2x16x16``, 512) and, as its rank
0, under ``FakeTensorMode`` on fake CUDA tensors (the card's path, the
codec's operators included; fake CPU tensors on a host whose torch has
no CUDA, ``specs.trace_device``), builds the rank-local state -- the
parameters (``sharding.shard_params``, FSDP pieces where ``cfg.fsdp``),
AdamW's state (posit16 ``m``, the port's training configuration), the
error feedback (``sharding.ef_shardings``; the multi-pod train cells of
a config with ``grad_compress``, exactly where the reference's step is
compressed), the caches and the rank's rows of the batch -- and traces
one step:

  train   -> ``make_train_step(mesh=)`` (pod-compressed where above)
  prefill -> ``make_prefill_step(mesh=)``
  decode  -> ``make_serve_step(mesh=)`` (posit weights where the config
             serves them, ``specs.serve_params_shape``)

It records, for a rank, under the reference's keys where they mean the
same: ``memory.{argument,output,temp,peak}_bytes_per_device`` (argument
bytes summed exactly from the rank-local leaves; temp the peak of the
storages made in the step alive at once, ``cost.StepCounter``; the peak
is argument + temp and leaves out the caching allocator's rounding,
fragmentation and cuBLAS workspaces),
``cost.flops_per_chip`` and ``cost.bytes_per_chip`` (``launch/cost.py``),
``collectives_per_chip`` (bytes by ``axis/op``) with the largest
entries by purpose, ``roofline`` (the H100's rates), ``model_flops_total``
and ``useful_flop_ratio``; and adds ``fits`` (the peak under the card's
80 GB), ``launches`` per kernel and ``device``.  Every number is counted
from shapes, none measured.  A cell that does not fit is reported as
such; a cell that cannot be traced fails, and ``--keep-going`` goes on.

hymba's prefill is a decode step a prompt token (32 768 of them in
``prefill_32k``): its step is traced at 2 and 3 prompt tokens with the
cell's cache and the counts extended linearly to the whole prompt (the
steps' shapes do not depend on the position; ``LOOPED_PREFILL``).

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi3-medium-14b \\
      --shape train_4k --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --keep-going
  PYTHONPATH=src python -m repro_torch.launch.dryrun --table   # the records as a table
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch import configs
from repro_torch import tree as T
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import cost, specs
from repro_torch.launch import mesh as M

OUT_DIR = os.path.join("build", "dryrun")
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}
# families whose prefill steps the decoder a prompt token at a time
LOOPED_PREFILL = ("hymba",)
DEVICE = "NVIDIA H100 SXM5 80 GB (the published sheet: 989.4 TFLOP/s bf16, 3.35 TB/s, " \
         "NVLink 4 at 450 GB/s a direction)"


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in T.leaves(tree)
               if isinstance(x, torch.Tensor))


def _storages(tree) -> set:
    return {x.untyped_storage()._cdata for x in T.leaves(tree) if isinstance(x, torch.Tensor)}


def trace_step(step, args):
    """Run ``step(*args)`` once under the counters, on the fake tensors
    of the mode in force.  Returns the counts of the step (``flops``,
    ``bytes``, ``launches``, ``wire``, ``temp_bytes``, ``output_bytes``)
    and its outputs."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.runtime import collectives

    collectives.wire.clear()
    before = _storages(args)
    with FlopCounterMode(display=False) as fc, cost.StepCounter(before) as bc:
        out = step(*args)
    peak = bc.peak
    outs = [x for x in T.leaves(out) if isinstance(x, torch.Tensor)
            and x.untyped_storage()._cdata not in before]
    counts = dict(flops=int(fc.get_total_flops()), bytes=int(bc.bytes),
                  launches=dict(bc.launches), wire={k: list(v) for k, v in collectives.wire.items()},
                  temp_bytes=int(peak), output_bytes=sum(x.numel() * x.element_size()
                                                         for x in outs))
    return counts, out


def _extend(c2: dict, c3: dict, n: int) -> dict:
    """Counts at ``n`` prompt tokens from those at 2 and 3 (a loop of
    identical steps: each step adds ``c3 - c2``)."""
    def lin(a, b):
        return a + (n - 2) * (b - a)
    return dict(flops=lin(c2["flops"], c3["flops"]), bytes=lin(c2["bytes"], c3["bytes"]),
                launches={k: lin(c2["launches"].get(k, 0), c3["launches"][k])
                          for k in c3["launches"]},
                wire={k: [lin(a, b) for a, b in zip(c2["wire"][k], c3["wire"][k])]
                      for k in c2["wire"]},
                temp_bytes=max(c2["temp_bytes"], c3["temp_bytes"]),
                output_bytes=c3["output_bytes"])


def build_cell(cfg, spec, mesh, multi_pod: bool):
    """The rank-local state and the step of a cell, under the fake mode
    in force: ``(step, args, argument_bytes, extra)``; ``extra`` says how
    the step was formed (compressed, looped)."""
    from repro_torch.compress import gradient as gc
    from repro_torch.models import get_family
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding, train_loop

    sizes = sharding.axis_sizes(mesh)
    whole = specs.params_shape(cfg)
    extra = {}
    if spec.kind == "train":
        params = sharding.shard_params(whole, mesh, cfg, fsdp=cfg.fsdp)
        opt_cfg = adamw.AdamWConfig(posit_moments=True)
        opt = adamw.init(params, opt_cfg)
        batch = specs.materialize(specs.input_specs(cfg, spec))
        n_pods = sizes.get("pod", 1)
        compressed = multi_pod and bool(cfg.grad_compress)
        step = train_loop.make_train_step(cfg, opt_cfg, n_pods=n_pods, compressed=compressed,
                                          mesh=mesh)
        extra["compressed"] = compressed
        if compressed:
            ef = gc.init_error_state(params)
            tiled = {k: v.reshape((n_pods, v.shape[0] // n_pods) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            args = (params, opt, ef, tiled, 0)
            extra["ef_bytes"] = _nbytes(ef)
        else:
            args = (params, opt, batch, 0)
        extra.update(param_bytes=_nbytes(params), opt_bytes=_nbytes(opt))
        return step, args, extra
    b = spec.global_batch
    r0, r1 = sharding.batch_rows(b, mesh)
    if spec.kind == "prefill":
        params = sharding.shard_params(whole, mesh, cfg)
        rows = {k: v[r0:r1] for k, v in specs.materialize(specs.input_specs(cfg, spec)).items()}
        step = train_loop.make_prefill_step(cfg, mesh)
        extra.update(param_bytes=_nbytes(params), rows=r1 - r0)
        return step, (params, rows), extra
    params = sharding.shard_params(specs.serve_params_shape(cfg, whole), mesh, cfg)
    tp = sharding.tensor_parallel(cfg, mesh, serve=True)
    lcfg = sharding.local_config(cfg, tp)
    dev = specs.trace_device()
    cache = get_family(cfg).init_cache(lcfg, r1 - r0, spec.seq_len, device=dev)
    token = torch.zeros((r1 - r0,), dtype=torch.int32, device=dev)
    extra.update(param_bytes=_nbytes(params), cache_bytes=_nbytes(cache), rows=r1 - r0)
    return train_loop.make_serve_step(cfg, mesh), (params, cache, token), extra


def count_cell(cfg, spec, mesh, multi_pod: bool):
    """Build and trace one cell on ``mesh`` (a fake mesh joined by the
    caller): ``(counts, argument_bytes, extra)``."""
    step, args, extra = build_cell(cfg, spec, mesh, multi_pod)
    arg_bytes = _nbytes(args)
    if spec.kind == "prefill" and cfg.family in LOOPED_PREFILL:
        params, rows = args
        s = spec.seq_len
        parts = []
        for n in (2, 3):
            short = {k: v[:, :n] if k == "tokens" else v for k, v in rows.items()}
            parts.append(trace_step(lambda p, r: step(p, r, max_len=s + 1), (params, short))[0])
        counts = _extend(parts[0], parts[1], s)
        extra["looped"] = "traced at 2 and 3 prompt tokens, extended to the prompt"
    else:
        counts = trace_step(step, args)[0]
    return counts, arg_bytes, extra


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str | None = OUT_DIR) -> dict:
    """Trace one cell (module docstring) and write its record to
    ``out_dir/<arch>__<shape>__<mesh>.json`` (not written with
    ``out_dir=None``).  Joins, then leaves, a fake process group."""
    import torch.distributed as dist

    from repro_torch.runtime import sharding

    spec = SHAPES[shape]
    cfg = configs.config_for_cell(arch, shape)
    if multi_pod:
        cfg = dataclasses.replace(cfg, batch_axes=("pod", "data"))
    mesh_shape, names = MESHES[multi_pod]
    n_chips = 1
    for k in mesh_shape:
        n_chips *= k
    record = {"arch": arch, "shape": shape, "mesh": "x".join(map(str, mesh_shape)),
              "kind": spec.kind, "ok": False, "device": DEVICE, "counted": True,
              "fake_device": specs.trace_device(), "n_layers": cfg.n_layers}
    sharding.whole_shapes(cfg)               # outside the fake mode: its own
    t0 = time.time()
    mesh = M.fake_mesh(mesh_shape, names, specs.trace_device())
    try:
        with specs.fake_mode():
            counts, arg_bytes, extra = count_cell(cfg, spec, mesh, multi_pod)
    finally:
        dist.destroy_process_group()
    record["trace_s"] = round(time.time() - t0, 2)
    record.update(extra)
    fill_record(record, counts, arg_bytes, cfg, spec, n_chips)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}__{shape}__{record['mesh']}.json"), "w") as f:
            json.dump(record, f, indent=2)
    return record


def fill_record(record, counts, arg_bytes, cfg, spec, n_chips):
    """The reference's keys (and ``fits``, ``launches``) from a step's
    counts."""
    peak = arg_bytes + counts["temp_bytes"]
    record["memory"] = {"argument_bytes_per_device": arg_bytes,
                        "output_bytes_per_device": counts["output_bytes"],
                        "temp_bytes_per_device": counts["temp_bytes"],
                        "peak_bytes_per_device": peak}
    record["fits"] = peak <= cost.HBM_BYTES
    record["cost"] = {"flops_per_chip": float(counts["flops"]),
                      "bytes_per_chip": float(counts["bytes"])}
    colls = cost.collective_bytes({tuple(k): v for k, v in counts["wire"].items()})
    record["collectives_per_chip"] = colls
    record["top_collectives"] = [
        {"bytes": b, "calls": c, "key": k}
        for b, c, k in cost.top_collectives({tuple(k): v for k, v in counts["wire"].items()},
                                            8)]
    record["roofline"] = cost.roofline_terms(
        flops_per_chip=float(counts["flops"]), bytes_per_chip=float(counts["bytes"]),
        coll_bytes_per_chip=float(sum(colls.values())), n_chips=n_chips)
    record["launches"] = counts["launches"]
    mf = cost.model_flops(cfg, spec)
    record["model_flops_total"] = mf
    total = counts["flops"] * n_chips
    record["useful_flop_ratio"] = (mf / total) if total else None
    record["ok"] = True
    return record


def table(out_dir: str = OUT_DIR) -> str:
    """A markdown table of the records in ``out_dir``, a row a cell in
    ``configs.all_cells()`` order and both meshes side by side (``16x16
    / 2x16x16``): the argument and peak GB a device (``*`` past 80 GB),
    FLOPs, bytes and collective bytes a chip, the dominant term and the
    useful-FLOP ratio; a missing or failed record reads ``--``."""
    def rec(arch, shape, mesh):
        path = os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            r = json.load(f)
        return r if r.get("ok") else None

    def both(fn, a, b):
        return " / ".join("--" if r is None else fn(r) for r in (a, b))

    def gb(key):
        return lambda r: (f"{r['memory'][key] / 1e9:.1f}"
                          + ("*" if key == "peak_bytes_per_device" and not r["fits"] else ""))
    rows = ["| arch | shape | argument GB | peak GB | FLOPs/chip | bytes/chip | "
            "collective B/chip | dominant | useful FLOP ratio |",
            "|---|---|---|---|---|---|---|---|---|"]
    for arch, shape in configs.all_cells():
        a, b = rec(arch, shape, "16x16"), rec(arch, shape, "2x16x16")
        rows.append("| " + " | ".join([
            arch, shape, both(gb("argument_bytes_per_device"), a, b),
            both(gb("peak_bytes_per_device"), a, b),
            both(lambda r: f"{r['cost']['flops_per_chip']:.3g}", a, b),
            both(lambda r: f"{r['cost']['bytes_per_chip']:.3g}", a, b),
            both(lambda r: f"{sum(r['collectives_per_chip'].values()):.3g}", a, b),
            both(lambda r: r["roofline"]["dominant"], a, b),
            both(lambda r: f"{r['useful_flop_ratio']:.3f}", a, b)]) + " |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=configs.ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--keep-going", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the records in --out as a markdown table and exit")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        return
    if not args.all and args.arch is None:
        ap.error("--arch, --all or --table")

    cells = list(configs.all_cells()) if args.all else [
        (args.arch, s) for s in
        (configs.supported_shapes(args.arch) if args.shape is None else [args.shape])]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failures, t_all = 0, time.time()
    for arch, shape in cells:
        for multi in meshes:
            tag = f"{arch} x {shape} x {'2x16x16' if multi else '16x16'}"
            try:
                rec = run_cell(arch, shape, multi, args.out)
                print(f"[OK] {tag}: trace={rec['trace_s']}s "
                      f"flops/chip={rec['cost']['flops_per_chip']:.3e} "
                      f"peak/dev={rec['memory']['peak_bytes_per_device'] / 2**30:.2f}GiB "
                      f"fits={rec['fits']} dominant={rec['roofline']['dominant']} (counted)",
                      flush=True)
                for top in rec["top_collectives"][:3]:
                    print(f"    {top['bytes']:.3e}B x{top['calls']:<6} {top['key']}", flush=True)
            except Exception:
                failures += 1
                print(f"[FAIL] {tag}", flush=True)
                traceback.print_exc()
                if not args.keep_going:
                    raise
    print(f"{len(cells) * len(meshes) - failures} of {len(cells) * len(meshes)} cells traced "
          f"in {time.time() - t_all:.1f} s", flush=True)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main(sys.argv[1:])
