"""End-to-end training example: a small LM on this repo's own text.

The port of the reference's ``examples/train_lm.py``, through the
port's ``launch/train.py``: config -> model (reduced gemma family) ->
deterministic byte-level pipeline -> AdamW with posit16 moments (the
codec's quantize and dequantize, ``csrc/posit_codec.cu``, on the GPU)
-> supervised loop with async checkpoints + resume + straggler
watchdog.  The loss must drop substantially within a few hundred steps.

The corpus is the repo's ``*.md`` and ``src/repro_torch/core/*.py``
(the reference reads its own ``src/repro/core/*.py``).  The corpus file
and the checkpoint directory go under a fresh temporary directory.

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import os
import tempfile

from repro_torch.device import resolve_device
from repro_torch.launch import train as train_main

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
STEPS = 300


def write_corpus(path: str) -> int:
    """The repo's documentation and the port's ``core`` sources, one
    file; returns its bytes."""
    n = 0
    with open(path, "w") as out:
        for pattern in ("*.md", "src/repro_torch/core/*.py"):
            for src in sorted(glob.glob(os.path.join(ROOT, pattern))):
                with open(src) as f:
                    n += out.write(f.read())
    return n


def run(device="cuda", steps: int = STEPS, arch: str = "gemma-7b") -> dict:
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="repro_train_lm_") as tmp:
        corpus = os.path.join(tmp, "corpus.txt")
        n_bytes = write_corpus(corpus)
        res = train_main.main([
            "--arch", arch, "--reduced",
            "--steps", str(steps),
            "--batch", "16", "--seq", "128",
            "--data", "bytes", "--corpus", corpus,
            "--lr", "1e-3", "--posit-moments",
            "--ckpt-dir", os.path.join(tmp, "ckpt"),
            "--save-every", "100",
            "--device", str(dev),
        ])
        res.ckpt.wait()
    losses = res.losses
    return dict(losses=losses, corpus_bytes=n_bytes,
                first=sum(losses[:10]) / 10, last=sum(losses[-10:]) / 10)


def check(res: dict) -> None:
    assert res["last"] < res["first"] * 0.8, "loss did not improve"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device, args.steps, args.arch)
    print(f"mean loss first-10={res['first']:.3f} last-10={res['last']:.3f}")
    check(res)
    print("OK: model learned")


if __name__ == "__main__":
    main()
