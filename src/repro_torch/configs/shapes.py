"""The dry run's input-shape sets, the same for every architecture.

A copy of ``repro/configs/shapes.py``.  ``kind`` selects the step that
``launch/dryrun.py`` traces:

  train   -> ``make_train_step``   (forward, backward and the optimizer)
  prefill -> ``make_prefill_step`` (the prompt pass that builds the cache)
  decode  -> ``make_serve_step``   (one new token against a seq_len cache)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}
