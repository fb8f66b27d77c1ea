"""Deterministic, index-addressable data pipeline.

The port of ``repro/data/pipeline.py``: every batch is a pure function
of ``(seed, step)`` and the model config, drawn with the same
blake2b-seeded numpy generators, so the tokens, whisper's ``frames`` and
a visual prefix equal the reference's bit for bit.  Resuming is
restoring one integer (the step); there is no iterator state.  Batches
leave as tensors on ``device`` (tokens int32, as the reference's).

Two sources: ``synthetic`` (Zipf-distributed tokens with a planted
bigram structure, so small models visibly learn) and ``bytes``
(byte-level tokens from a text file).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    source: str = "synthetic"     # synthetic | bytes
    seed: int = 1234
    path: Optional[str] = None    # bytes mode
    zipf_a: float = 1.2


def _rng_for(seed: int, step: int, stream: str):
    h = hashlib.blake2b(f"{seed}:{step}:{stream}".encode(),
                        digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(h, "little"))


class Pipeline:
    def __init__(self, dcfg: DataConfig, mcfg: ModelConfig,
                 global_batch: int, seq_len: int, *, device="cuda"):
        self.dcfg = dcfg
        self.mcfg = mcfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.device = resolve_device(device)
        self._corpus = None
        if dcfg.source == "bytes":
            with open(dcfg.path, "rb") as f:
                self._corpus = np.frombuffer(f.read(), dtype=np.uint8)
            if len(self._corpus) < seq_len + 1:
                raise ValueError("corpus too small")

    def batch_at(self, step: int) -> dict:
        """The batch at ``step``: tensors on the pipeline's device."""
        b, s, v = self.global_batch, self.seq_len, self.mcfg.vocab
        rng = _rng_for(self.dcfg.seed, step, "tokens")
        if self.dcfg.source == "bytes":
            starts = rng.integers(0, len(self._corpus) - s - 1, size=b)
            tok = np.stack([self._corpus[st:st + s].astype(np.int32)
                            for st in starts])
            tok = tok % v
        else:
            # Zipf body with planted bigram structure: token 2k is
            # followed by 2k+1 with high probability
            base = rng.zipf(self.dcfg.zipf_a, size=(b, s)).astype(np.int64)
            tok = (base % max(v - 2, 1)).astype(np.int32)
            follow = rng.random((b, s)) < 0.7
            shifted = np.roll(tok, 1, axis=1)
            paired = np.where((shifted % 2 == 0) & follow[:, :],
                              np.minimum(shifted + 1, v - 1), tok)
            paired[:, 0] = tok[:, 0]
            tok = paired.astype(np.int32)

        out = {"tokens": tok}
        if self.mcfg.family == "whisper":
            frng = _rng_for(self.dcfg.seed, step, "frames")
            out["frames"] = frng.standard_normal(
                (b, self.mcfg.encoder_seq, self.mcfg.d_model)).astype(np.float32)
        if self.mcfg.n_visual_tokens:
            vrng = _rng_for(self.dcfg.seed, step, "visual")
            out["visual"] = vrng.standard_normal(
                (b, self.mcfg.n_visual_tokens, self.mcfg.d_model)).astype(np.float32)
        return {k: torch.from_numpy(a).to(self.device) for k, a in out.items()}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
