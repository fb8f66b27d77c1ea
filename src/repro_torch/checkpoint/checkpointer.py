"""Fault-tolerant checkpointing: atomic, async, keep-last-k.

The port of ``repro/checkpoint/checkpointer.py``, on the reference's
on-disk layout: ``<dir>/step_%08d/arrays.npz`` (leaf ``i`` as ``a{i}``,
in the tree's walk order) beside ``checkpoint_complete.json`` (the step
and each leaf's ``path``, ``dtype``, ``shape`` and ``codec``).

* Atomic: written to ``<dir>/tmp.<step>``, then ``os.replace``d; a crash
  mid-save never corrupts the latest checkpoint.
* Async: the host copy is taken in the caller's thread (a leaf already
  on the host is copied too), the file is written by a worker thread;
  ``wait()`` joins it (every save and restore waits for the one before).
* Free space is checked before the host copy: a save that would not fit
  raises ``OSError`` instead of writing part of a checkpoint.
* ``posit_payload``: f32 leaves are stored as posit16 patterns (half the
  bytes), quantized where they live (``csrc/posit_codec.cu``'s quantize
  on the card) before the host copy, and dequantized on restore.

* Elastic: a checkpoint holds whole leaves and no record of the mesh
  that wrote it.  Under a rank mesh (``mesh=``) a save gathers each
  split leaf whole over its axes, bit for bit (``save(shardings=)``,
  ``sharding.param_shardings``), rank 0 writes it in the single-device
  format and leaf order, and every rank waits for the write (a save
  under a mesh is blocking).  ``restore(..., shardings=)`` narrows each
  whole leaf to this rank's piece of the mesh it is given, so a
  checkpoint saved on one mesh restores on any other (or on one
  device).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.core.types import POSIT16, signed_view
from repro_torch.kernels import posit_codec
from repro_torch.runtime.sharding import unshard

_SENTINEL = "checkpoint_complete.json"
_FREE_MARGIN = 64 << 20          # bytes kept free beyond the checkpoint's
_UNSIGNED = {torch.uint16: np.uint16, torch.uint32: np.uint32}
_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor as numpy; unsigned patterns keep their dtype
    and bf16 goes as its uint16 bits.  A tensor already on the host is
    cloned: numpy would share its memory, and the optimizer goes on
    writing the live tensors in place while the worker thread writes
    the file."""
    t = t.detach()
    t = t.clone() if t.device.type == "cpu" else t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype in _UNSIGNED:
        return signed_view(t).numpy().view(_UNSIGNED[t.dtype])
    return t.numpy()


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype in _SIGNED:
        return torch.from_numpy(a.view(_SIGNED[a.dtype])).view(getattr(torch, str(a.dtype)))
    return torch.from_numpy(a)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 posit_payload: bool = False, mesh=None):
        self.dir = directory
        self.keep = keep
        self.posit_payload = posit_payload
        self.mesh = mesh
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # the last save's bytes, host-copy and write seconds, and the
        # last wait() that joined a save
        self.last_save: dict = {}
        self.last_wait_s = 0.0
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False, shardings=None):
        """Snapshot ``tree`` at ``step`` (async unless ``blocking``).
        ``shardings`` (a tree of ``sharding.NamedSharding`` like
        ``tree``): each leaf is this rank's piece, gathered whole before
        the write; every rank of the mesh must call it."""
        self.wait()
        named = [(p, torch.as_tensor(x)) for p, x in T.leaves_with_paths(tree)]
        if shardings is not None:
            named = [(p, unshard(x, sh)) for (p, x), sh in zip(named, T.leaves(shardings))]
        if self.mesh is not None:
            if dist.get_rank() == 0:
                self._write(step, named, blocking=True)
            del named
            dist.barrier()
            return
        self._write(step, named, blocking)

    def _write(self, step: int, named, blocking: bool):
        stored = []
        for path, x in named:
            entry = {"path": path, "dtype": _dtype_name(x), "shape": list(x.shape),
                     "codec": "raw"}
            if self.posit_payload and x.dtype == torch.float32:
                x = posit_codec.quantize(x.detach().contiguous(), POSIT16)
                entry["codec"] = "posit16"
            stored.append((entry, x))
        nbytes = sum(x.numel() * x.element_size() for _, x in stored)
        free = shutil.disk_usage(self.dir).free
        if nbytes + _FREE_MARGIN > free:
            raise OSError(
                f"checkpoint of step {step} needs {nbytes:,} bytes in {self.dir} "
                f"but only {free:,} are free; point the checkpoint directory at a "
                "larger file system")
        t0 = time.perf_counter()
        arrays = {f"a{i}": _to_host(x) for i, (_, x) in enumerate(stored)}
        meta = {"step": step, "leaves": [e for e, _ in stored]}
        del stored, named
        self.last_save = {"step": step, "bytes": nbytes,
                          "host_copy_s": time.perf_counter() - t0}

        def work():
            t1 = time.perf_counter()
            tmp = os.path.join(self.dir, f"tmp.{step}")
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, _SENTINEL), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)                      # atomic publish
            self._gc()
            self.last_save["write_s"] = time.perf_counter() - t1

        if blocking:
            work()
            return

        def guarded():
            try:
                work()
            except BaseException as e:                  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=guarded, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the save in flight, if any; re-raise its error."""
        if self._thread is not None:
            t0 = time.perf_counter()
            self._thread.join()
            self._thread = None
            self.last_wait_s = time.perf_counter() - t0
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = []
        for name in os.listdir(self.dir):
            full = os.path.join(self.dir, name)
            if (name.startswith("step_")
                    and os.path.exists(os.path.join(full, _SENTINEL))):
                steps.append(int(name.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, step: int, tree_template, shardings=None, device=None):
        """Restore into the structure of ``tree_template``: each leaf on
        ``device``, or on its template leaf's device.  ``shardings`` (a
        tree like the template of ``sharding.NamedSharding``, or
        ``None`` leaves for whole ones) narrows each whole leaf to this
        rank's piece of its mesh: the elastic re-mesh.  Returns ``(tree,
        step)``."""
        self.wait()
        final = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(final, _SENTINEL)) as f:
            meta = json.load(f)
        templ = T.leaves(tree_template)
        if len(templ) != len(meta["leaves"]):
            raise ValueError(f"checkpoint of step {step} holds {len(meta['leaves'])} "
                             f"leaves, the template {len(templ)}")
        data = np.load(os.path.join(final, "arrays.npz"))
        places = T.leaves(shardings) if shardings is not None else [None] * len(templ)
        out = []
        for i, (entry, like, sh) in enumerate(zip(meta["leaves"], templ, places)):
            dev = device if device is not None else torch.as_tensor(like).device
            arr = data[f"a{i}"]
            posit = entry["codec"] == "posit16"
            x = _from_host(arr, "uint16" if posit else entry["dtype"])
            x = (x if sh is None else sh.shard(x)).to(dev)
            out.append(posit_codec.dequantize(x, POSIT16) if posit else x)
        return T.unflatten(tree_template, out), meta["step"]

    # ------------------------------------------------------------------
    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
